"""Sweep CLI of the port: train one head on many categories through the
sweep engine (`pipeline/sweep.py`); the port's counterpart of the root
`trainings_loop.py` (reference trainings_loop.py:91-190), with its flags and
per-architecture defaults:

    python -m vit_ad_tpu_torch.cli.trainings_loop -a nf|mdn|recon \\
        -d <data root> -o <out dir> -m <model> -c <cat1,cat2,...> \\
        [-e epochs -b batch -i imgSize -p patience -n gaussians -l lr -w wd] \\
        [-j workers] [--mesh DxM] [--device cuda|cpu]

Defaults: nf 500 epochs, patience 60, lr 1e-3, wd 1e-5, batch 32; mdn 1000,
100, 7e-4, wd 7e-4, batch 64, K 100; recon 50, 30, 1e-3, wd 1e-4, batch 64
on ae_deit unless -m names an ae_* model. `-m` with `res_net` takes the
multi-stage trainers (`mdn_resnet`, `nf_resnet`). A data root with `btad` in
its path sweeps the BTAD categories on `train/ok`, else the MVTec ones on
`train/good`. `-j N` (N > 1) fans the categories out to N worker processes,
one card each (`run_sweep_parallel`); `--device cpu` runs them on the CPU.
Without a card `--device cuda` (the default) exits (the sweep's device
check). The variational auto-encoder has no flag here, as in the root
script: `run_sweep(resolve_trainer("vae"), ...)` trains it. `--mesh DxM`
trains every run sharded over D·M ranks: with `-j N`, each of the N workers
on its own group of D·M cards (explicit sizes; 'auto' is refused there), else
the CLI's ranks (an explicit cluster, or spawned by the CLI,
`parallel/launch.launch_cli`) run the sweep together and the primary writes.

Writes `<out>/results.csv` (one row per category, the reference's metric
names), `<out>/<category>/done.json` (a finished run is not trained again
while its hyper-parameters match) and `<out>/dataset_distribution.png`, and
prints the mean image AUROC.
"""

from __future__ import annotations

import dataclasses
import getopt
import os
import sys

from vit_ad_tpu_torch.config import HyperParams

USAGE = ("python -m vit_ad_tpu_torch.cli.trainings_loop -a <arch: nf|mdn|recon> "
         "-d <dataRoot> -o <outDir> -m <model> -c <cat1,cat2,...> [-e epochs -b batch "
         "-i imgSize -p patience -n gaussians -l lr -w wd -j workers --mesh DxM "
         "--device cuda|cpu]\n"
         "  -j N > 1 fans the categories out to N worker processes, one card each (D*M each "
         "with --mesh DxM)")


def base_hp(arch: str, model: str) -> HyperParams:
    """The root script's per-architecture defaults."""
    if arch == "nf":
        return HyperParams(model_name=model, architecture="nf", epochs=500, patience=60,
                           learning_rate=1e-3, weight_decay=1e-5, batch_size=32,
                           hidden_ratio=0.16, flow_steps=20)
    if arch == "mdn":
        return HyperParams(model_name=model, architecture="mdn", epochs=1000, patience=100,
                           learning_rate=7e-4, weight_decay=7e-4, batch_size=64,
                           num_gaussians=100)
    if arch == "recon":
        return HyperParams(model_name=model if model.startswith("ae_") else "ae_deit",
                           architecture="reconstruction", epochs=50, patience=30,
                           learning_rate=1e-3, weight_decay=1e-4, batch_size=64)
    raise SystemExit(f"unknown arch {arch!r}")


def main(argv=None) -> int:
    from vit_ad_tpu_torch.config import MeshConfig, set_numerics_policy
    from vit_ad_tpu_torch.parallel.launch import launch_cli
    from vit_ad_tpu_torch.parallel.multihost import is_primary, maybe_initialize_distributed
    from vit_ad_tpu_torch.pipeline.sweep import (
        BTAD_CATEGORIES,
        MVTEC_CATEGORIES,
        SweepRun,
        resolve_trainer,
        run_sweep,
        run_sweep_parallel,
    )

    arch, data_root, out_dir, model = "nf", "data/mvtec_anomaly_detection", "sweep_results", \
        "enc_deit"
    categories, workers, device, mesh = None, 1, "cuda", MeshConfig()
    overrides = {}
    keys = {"-e": ("epochs", int), "-b": ("batch_size", int), "-i": ("img_size", int),
            "-p": ("patience", int), "-n": ("num_gaussians", int),
            "-l": ("learning_rate", float), "-w": ("weight_decay", float)}
    argv = sys.argv[1:] if argv is None else argv
    maybe_initialize_distributed()
    opts, _ = getopt.getopt(argv, "ha:d:o:m:c:e:b:i:p:n:l:w:j:", ["mesh=", "device="])
    for opt, arg in opts:
        if opt == "-h":
            print(USAGE)
            return 0
        if opt == "--mesh":
            mesh = MeshConfig.parse(arg)
        elif opt == "-a":
            arch = arg
        elif opt == "-d":
            data_root = arg
        elif opt == "-o":
            out_dir = arg
        elif opt == "-m":
            model = arg
        elif opt == "-c":
            categories = arg.split(",")
        elif opt == "-j":
            workers = int(arg)
        elif opt == "--device":
            device = arg
        elif opt in keys:
            field, kind = keys[opt]
            overrides[field] = kind(arg)
    if workers == 1:
        launched = launch_cli("vit_ad_tpu_torch.cli.trainings_loop", argv, mesh, device)
        if launched is not None:
            return launched
    set_numerics_policy()

    is_btad = "btad" in data_root
    if categories is None:
        categories = list(BTAD_CATEGORIES if is_btad else MVTEC_CATEGORIES)
    train_pref = "train/ok" if is_btad else "train/good"
    hp = dataclasses.replace(base_hp(arch, model), mesh=mesh, **overrides)
    # the multi-stage ResNet trainers (reference startTraining_*.py:134-152)
    if "res_net" in model and arch in ("mdn", "nf"):
        arch = f"{arch}_resnet"
    runs = [SweepRun(category=c, data_root=data_root, train_pref=train_pref)
            for c in categories]
    if workers > 1:
        rows = run_sweep_parallel(arch, hp, runs, out_dir, workers,
                                  platform="cpu" if device == "cpu" else "cuda")
    else:
        rows = run_sweep(resolve_trainer(arch), hp, runs, out_dir, device=device)
    if not is_primary():
        return 0
    ok = [r for r in rows if "image_auroc_score" in r]
    if ok:
        mean = sum(r["image_auroc_score"] for r in ok) / len(ok)
        print(f"mean image AUROC over {len(ok)} categories: {mean:.4f}")
    try:  # the training images per category (reference ImageHelper.py:225-306)
        from vit_ad_tpu_torch.data.files import join_to_file_list
        from vit_ad_tpu_torch.utils.images import plot_dataset_distribution, save_png

        counts = {c: len(join_to_file_list(os.path.join(data_root, c), train_pref,
                                           shuffle=False)) for c in categories}
        save_png(plot_dataset_distribution(counts, title=f"{arch} sweep data"),
                 os.path.join(out_dir, "dataset_distribution.png"))
    except Exception as e:  # a figure never fails the sweep
        print(f"distribution plot skipped: {type(e).__name__}: {e}")
    print(f"results: {out_dir}/results.csv")
    return 0


if __name__ == "__main__":
    sys.exit(main())
