"""Score a folder of images with reference-format `.pth` weights on the GPU.

Port of `python -m vit_ad_tpu.cli.score` (the `--pth` path: NF, MDN and
reconstruction heads):

    python -m vit_ad_tpu_torch.cli.score --pth <head .pth> -a nf|mdn \\
        -m enc_deit|enc_vit|enc_esvit|enc_nest|enc_eff_former|enc_eff_net \\
        -E <trunk .pth> -d /path/to/images \\
        [-o out_dir] [-b BATCH] [--fused-ln|--no-fused-ln] [--fused-mlp|--no-fused-mlp]
    python -m vit_ad_tpu_torch.cli.score --pth <stage-2 head .pth> <stage-3 head .pth> \\
        -a mdn -E <ResNet encoder .pth> -d /path/to/images
    python -m vit_ad_tpu_torch.cli.score --pth <auto-encoder .pth> -a recon -m ae_* \\
        -d /path/to/images [--fused-ln|--no-fused-ln] [--fused-mlp|--no-fused-mlp]

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
and NesT trunks' LayerNorms through the one-pass kernel or not, `--fused-mlp` / `--no-fused-mlp` the
ViT/DeiT blocks' MLP tail through the fused kernel or not (default of both:
the model's).

A head trained by the port's trainers has `config.json` beside its `.pth`
(`cli/common.RUN_CONFIG_KEYS`); scoring reads it back when it sits beside the
first `.pth`: the head is scored on features of the recorded depth
(`block_index`, `-s` of the trainer), and a run trained with `--centering` is
standardized with the mean and std of `--train-data` (the training image
dir), as the JAX CLI does for its run directories. Without `config.json` the
features are full depth and the statistics ImageNet's.

Outputs (under -o, default `<pth stem>_scores`), as the JAX CLI writes them:
  scores.csv      path,image_score — one row per input image, input order
  summary.json    n_images, score stats, run config echo

Image score: max over the NF anomaly map (reference ValidatorNF.py:137-142)
or over the recon squared-error map (ValidatorRecon.py:115-117); for MDN the
inverted min patch probability (reference ValidatorMDN.py:133).
Run directories (`-r`, orbax checkpoints), `--watch`, `--heatmaps`, `--mesh`
and `--weights-dtype bf16` are ROADMAP A10/A11 and exit with a message.
`--device` defaults to cuda; without a card the CLI exits unless `--device
cpu` is given.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import List, Optional

import numpy as np

from vit_ad_tpu_torch.cli.common import RUN_CONFIG, check_device
from vit_ad_tpu_torch.config import set_numerics_policy
from vit_ad_tpu_torch.data.files import IMAGE_EXTENSIONS
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
) -> dict:
    """Score a folder with a reference-format head `.pth` (plus the pretrained
    trunk `encoder_ckpt`), or with the two stage-head files of the ResNet-MDN
    convention; write scores.csv and summary.json; return the summary. The
    feature depth and the centering come from the `config.json` beside the
    first `.pth` (`run_config`); `train_data` is read by centering runs."""
    from vit_ad_tpu_torch.pipeline.loading import build_pth_models, build_pth_resnet_mdn_models

    cfg = run_config(pths[0])
    if len(pths) == 2:
        if arch != "mdn":
            raise SystemExit("two .pth files = the ResNet-MDN convention; use -a mdn")
        models = build_pth_resnet_mdn_models(pths, img_size=img_size,
                                             encoder_ckpt=encoder_ckpt, device=device)
    elif len(pths) == 1:
        models = build_pth_models(pths[0], model_name, arch, img_size=img_size,
                                  hidden_ratio=hidden_ratio, flow_steps=flow_steps,
                                  encoder_ckpt=encoder_ckpt, device=device, fused_ln=fused_ln,
                                  fused_mlp=fused_mlp, block_index=cfg.get("block_index", 0))
    else:
        raise SystemExit(f"--pth takes one head file, or the two stage-head files of the "
                         f"ResNet-MDN convention; got {len(pths)}")
    hp = models.hp
    if batch:
        hp.batch_size = batch
    mean, std = norm_stats_for(cfg.get("centering", False), train_data, hp.img_size,
                               hp.batch_size)
    return _score_with_models(models, pths[0], {"architecture": arch}, images_dir,
                              out_dir or os.path.splitext(pths[0])[0] + "_scores", mean, std)


def _score_with_models(models, source: str, cfg: dict, images_dir: str, out_dir: str,
                       mean, std) -> dict:
    from vit_ad_tpu_torch.data.loader import DataPipeline
    from vit_ad_tpu_torch.pipeline.loading import score_models

    files = list_images(images_dir)
    if not files:
        raise SystemExit(f"no images found under {images_dir!r}")
    hp = models.hp
    pipe = DataPipeline(batch_size=hp.batch_size, img_size=hp.img_size, files=files)
    s = score_models(models, pipe, mean, std)

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "scores.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["path", "image_score"])
        for path, score in zip(files, s.image_scores):
            w.writerow([path, repr(float(score))])
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
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="score a folder of images with reference-format legacy .pth "
                    "weights (PyTorch/CUDA port)")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("-r", "--run", help="run dir (not ported: orbax needs jax)")
    src.add_argument("--pth", nargs="+", metavar="PTH",
                     help="reference-format .pth head weights; needs -a")
    ap.add_argument("-d", "--images", required=True,
                    help="directory of images to score (recursive)")
    ap.add_argument("-o", "--out", default="", help="output dir (default <pth>_scores)")
    ap.add_argument("--heatmaps", type=int, default=0, help="not ported (ROADMAP A10)")
    ap.add_argument("-b", "--batch", type=int, default=0, help="scoring batch size")
    ap.add_argument("--train-data", default="",
                    help="training image dir (only --centering runs read it: their "
                         "config.json says so)")
    ap.add_argument("--mesh", default="", help="not ported (ROADMAP A11)")
    ap.add_argument("--watch", type=float, default=0.0, metavar="SECS",
                    help="not ported (ROADMAP A10)")
    ap.add_argument("--watch-waves", type=int, default=0, help="not ported (ROADMAP A10)")
    ap.add_argument("-a", "--arch", default="", help="nf | mdn | recon")
    ap.add_argument("-m", "--model", default="enc_deit",
                    help="registry key: the encoder (nf, mdn) or the auto-encoder (recon: ae_*)")
    ap.add_argument("-E", "--encoder-ckpt", default="",
                    help="pretrained trunk the head was trained against (timm ViT/DeiT, "
                         "NesT or EfficientFormer .pth, the EsViT Swin-T .pth for -m "
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
                    help="weights at rest (auto = f32; bf16: ROADMAP A10)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; give --device cpu to run on the CPU)")
    args = ap.parse_args(argv)
    if args.run:
        ap.error("-r/--run: run directories hold orbax checkpoints, which need jax; "
                 "the port scores --pth weights (run dirs: ROADMAP A10)")
    for flag, on, item in (("--watch", args.watch, "A10"), ("--heatmaps", args.heatmaps, "A10"),
                           ("--mesh", args.mesh, "A11"),
                           ("--weights-dtype bf16", args.weights_dtype == "bf16", "A10")):
        if on:
            ap.error(f"{flag} is not ported to vit_ad_tpu_torch yet (ROADMAP {item})")
    if not args.arch:
        ap.error("--pth needs -a nf, -a mdn or -a recon")
    if args.arch not in ("nf", "mdn", "recon"):
        ap.error(f"-a {args.arch}: the heads are nf, mdn and recon")
    if args.arch == "recon" and not args.model.startswith("ae_"):
        ap.error(f"-a recon scores an auto-encoder: give its registry key (-m ae_*), not "
                 f"{args.model!r}")
    if args.model not in get_possible_models():
        ap.error(f"-m {args.model}: unknown model; known: {', '.join(get_possible_models())}")
    if args.fused_ln is not None and args.model not in FUSED_LN_MODELS:
        ap.error(f"--fused-ln/--no-fused-ln: -m {args.model} has no fused LayerNorm path "
                 f"(models that have: {', '.join(FUSED_LN_MODELS)})")
    if args.fused_mlp is not None and (args.model not in FUSED_MLP_MODELS
                                       or len(args.pth) != 1):
        ap.error(f"--fused-mlp/--no-fused-mlp: only -m {' or '.join(FUSED_MLP_MODELS)} has a "
                 "fused MLP path")
    device = check_device(args.device)
    set_numerics_policy()
    summary = score_pth(args.pth, args.arch, args.images, out_dir=args.out or None,
                        model_name=args.model, img_size=args.img_size,
                        hidden_ratio=args.hidden_ratio, flow_steps=args.flow_steps,
                        encoder_ckpt=args.encoder_ckpt, batch=args.batch, device=device,
                        fused_ln=args.fused_ln, fused_mlp=args.fused_mlp,
                        train_data=args.train_data)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
