"""Export a trained run (or reference-format `.pth` weights) as a serving
bundle — `python -m vit_ad_tpu_torch.cli.export_serving` (port of
`vit_ad_tpu/cli/export_serving.py`, the same flags, plus `--device`).

The bundle (`serving/aot.py`) is the uint8→scores program with the run's
weights in it: the serving site loads it with torch and numpy alone, with no
model code, registry or checkpoint loading (the reference needs the whole
model zoo per weight file, reference validation_loop.py:248-274).

    # a portable bundle of a run directory, batch 64, for the CPU and the card
    python -m vit_ad_tpu_torch.cli.export_serving -r runs/<run> -o bundle/ \\
        -b 64 --platforms cpu,cuda

    # a native bundle (the CUDA kernels kept as ops), traced on the card
    python -m vit_ad_tpu_torch.cli.export_serving -r runs/<run> -o bundle/ --native

    # reference-format .pth weights
    python -m vit_ad_tpu_torch.cli.export_serving --pth 100_gaussians_bottle.pth \\
        -a mdn --model enc_deit -E deit.pth -o bundle/

    # score a folder with a bundle
    python - <<'PY'
    from vit_ad_tpu_torch.serving.aot import load_bundle
    from vit_ad_tpu_torch.cli.score import list_images
    scores, maps = load_bundle("bundle/").score_files(list_images("imgs/"))
    PY
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="export_serving",
        description="Export a trained run as a serving bundle (a torch.export program with "
                    "the weights in it; PyTorch/CUDA port).")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("-r", "--run", help="training run directory (config.json + the "
                     "checkpoints it lists)")
    src.add_argument("--pth", nargs="+", metavar="PTH",
                     help="reference-format .pth weight file(s); two files = the ResNet-MDN "
                     "two-file convention")
    ap.add_argument("-a", "--arch", choices=["mdn", "nf", "recon"],
                    help="head architecture (required with --pth)")
    ap.add_argument("--model", default="enc_deit",
                    help="backbone registry key for --pth (default enc_deit; ae_* for recon)")
    ap.add_argument("--img-size", type=int, default=224)
    ap.add_argument("--hidden-ratio", type=float, default=0.16)
    ap.add_argument("--flow-steps", type=int, default=20)
    ap.add_argument("-E", "--encoder-ckpt", default="",
                    help="pretrained trunk weights for --pth heads (.pth)")
    ap.add_argument("-o", "--out", required=True, help="bundle output dir")
    ap.add_argument("-b", "--batch", type=int, default=32,
                    help="the program's fixed batch (serving pads and loops; default 32)")
    ap.add_argument("--platforms", default="",
                    help="comma-separated serving devices, cpu and/or cuda (default: the "
                    "export device)")
    ap.add_argument("--native", action="store_true",
                    help="keep the CUDA kernels in the program as ops (exported and served "
                    "on the card; default: a portable program of aten ops)")
    ap.add_argument("--payload", choices=["full", "scores"], default="full",
                    help="full = the evaluators' device payload (anomaly maps); scores = the "
                    "image-score tail in the program, [B] floats only (MDN kinds need "
                    "--ref-images)")
    ap.add_argument("--weights", choices=["baked", "external"], default="baked",
                    help="baked = the parameters saved in scorer.pt2; external = program "
                    "inputs, written to weights.npz beside it")
    ap.add_argument("--train-data", default="",
                    help="training image dir: required for --centering runs, so the "
                    "program standardizes as training did")
    ap.add_argument("--ref-images", default="",
                    help="image dir (e.g. the training images) whose max log-likelihood "
                    "becomes MDN bundles' fixed score normalizer, so serving scores compare "
                    "across calls; default: the reference's per-call-set normalization")
    ap.add_argument("--device", default="cuda",
                    help="device the models are traced on (default cuda; give --device cpu "
                    "to export on the CPU)")
    args = ap.parse_args(argv)
    if args.pth and not args.arch:
        ap.error("--pth needs -a/--arch")

    from vit_ad_tpu_torch.cli.common import check_device
    from vit_ad_tpu_torch.cli.score import (
        _build_pth_models_cli,
        list_images,
        norm_stats_for,
        run_config,
    )
    from vit_ad_tpu_torch.config import set_numerics_policy
    from vit_ad_tpu_torch.pipeline.loading import load_run
    from vit_ad_tpu_torch.serving.aot import decode_files, export_bundle

    device = check_device(args.device)
    set_numerics_policy()
    if args.run:
        models, _ = load_run(args.run, device)
        centering, source = models.hp.centering, args.run
    else:
        cfg = run_config(args.pth[0])
        models = _build_pth_models_cli(args.pth, args.arch, args.model, args.img_size,
                                       args.hidden_ratio, args.flow_steps, args.encoder_ckpt,
                                       device, None, None, cfg)
        centering, source = cfg.get("centering", False), args.pth[0]
    img = models.hp.img_size
    mean, std = norm_stats_for(centering, args.train_data, img, args.batch)
    ref_images = None
    if args.ref_images:
        ref_images = decode_files(list_images(args.ref_images), img, args.batch)
    manifest = export_bundle(
        models, args.out, batch=args.batch,
        platforms=[p for p in args.platforms.split(",") if p] or None,
        portable=not args.native, mean=mean, std=std, extra_meta={"source": source},
        ref_images=ref_images, weights=args.weights, payload=args.payload)
    print(f"exported {manifest['kind']} bundle → {args.out} (batch {manifest['batch']}, "
          f"platforms {manifest['platforms']}, {'portable' if manifest['portable'] else 'native'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
