"""Re-evaluate trained runs with labels (the port's counterpart of the root
`validation_loop.py`, which re-evaluates the JAX package's runs; reference
validation_loop.py:248-274 rebuilds a model and validator per saved file).

    python -m vit_ad_tpu_torch.cli.validate -r <runs dir> [-d <data root>] \\
        [-t test] [--device cuda|cpu]
    python -m vit_ad_tpu_torch.cli.validate -r <dir of .pth files> -a mdn|nf|recon \\
        [-m <model>] [-f <flow steps>] [-i <img size>] [-E <trunk .pth>] -d <data root>

Every directory under `-r` that holds a `config.json` is a run directory a
trainer CLI wrote (`cli/common.py`): its models are rebuilt
(`pipeline/loading.load_run`) and evaluated on the labelled test split of its
category (`evaluate_models`), standardized as in training (a `--centering` run
recomputes the mean and std of its training split). `-d` is the dataset root
(joined with the run's class where that holds a `-t` folder) or the category
itself; without it, the category the run trained on (`base_path`). With `-a`,
the reference-format `.pth` files directly under `-r` are evaluated too
(`build_pth_models`; the class from the file name, under `-d`).

Writes `<runs dir>/validation_results.csv` (one row per run or file: its
name and the reference metrics). A run that fails is reported and the rest
go on; the CLI then exits non-zero.
"""

from __future__ import annotations

import csv
import getopt
import glob
import os
import sys
from typing import Dict, List, Optional

USAGE = ("usage: -r <runsDir> [-d <dataRoot>] [-t <testPref>] [--device cuda|cpu]\n"
         "  reference .pth files under -r: -a <mdn|nf|recon> [-m <model>] [-f <flowSteps>] "
         "[-i <imgSize>] [-E <trunk .pth>]")


def validate_run(run_dir: str, data_root: str = "", test_pref: str = "test",
                 device: Optional[str] = None) -> Dict[str, float]:
    """The metrics of one run directory on its labelled test split (JAX
    `validation_loop.validate_run`)."""
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.data.loader import DataPipeline
    from vit_ad_tpu_torch.pipeline.loading import evaluate_models, load_run

    models, cfg = load_run(run_dir, device)
    hp = models.hp
    base = data_root or hp.base_path
    joined = os.path.join(base, str(cfg.get("data_class", "")))
    if cfg.get("data_class") and os.path.isdir(os.path.join(joined, test_pref.split("/")[0])):
        base = joined
    test = DataPipeline(hp.batch_size, hp.img_size, base_path=base, data_path=test_pref,
                        validation_mode=True)
    if hp.centering:
        mean, std = DataPipeline(hp.batch_size, hp.img_size, base_path=base,
                                 data_path=cfg.get("train_pref", "train/good")
                                 ).compute_mean_std()
    else:
        mean, std = default_norm_stats()
    return evaluate_models(models, test, mean, std)


def validate_pth(pth_path: str, model_name: str, arch: str, data_root: str,
                 test_pref: str = "test", img_size: int = 224, hidden_ratio: float = 0.16,
                 flow_steps: int = 20, encoder_ckpt: str = "",
                 device: Optional[str] = None) -> Dict[str, float]:
    """The metrics of a reference-format head `.pth` on the test split of its
    class (JAX `validation_loop.validate_pth`)."""
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.data.loader import DataPipeline
    from vit_ad_tpu_torch.pipeline.loading import build_pth_models, evaluate_models

    models = build_pth_models(pth_path, model_name, arch, img_size=img_size,
                              hidden_ratio=hidden_ratio, flow_steps=flow_steps,
                              encoder_ckpt=encoder_ckpt, device=device)
    hp = models.hp
    base = os.path.join(data_root, hp.data_class) if data_root else hp.data_class
    test = DataPipeline(hp.batch_size, hp.img_size, base_path=base, data_path=test_pref,
                        validation_mode=True)
    return evaluate_models(models, test, *default_norm_stats())


def main(argv=None) -> int:
    from vit_ad_tpu_torch.cli.common import check_device
    from vit_ad_tpu_torch.config import set_numerics_policy

    opts, _ = getopt.getopt(sys.argv[1:] if argv is None else argv, "hr:d:t:m:a:f:i:E:",
                            ["device="])
    runs_dir, data_root, test_pref, model_name, arch = "runs", "", "test", "enc_deit", ""
    flow_steps, img_size, encoder_ckpt, device = 20, 224, "", "cuda"
    for opt, arg in opts:
        if opt == "-h":
            print(USAGE)
            return 0
        if opt == "-r":
            runs_dir = arg
        elif opt == "-d":
            data_root = arg
        elif opt == "-t":
            test_pref = arg
        elif opt == "-m":
            model_name = arg
        elif opt == "-a":
            arch = arg
        elif opt == "-f":
            flow_steps = int(arg)
        elif opt == "-i":
            img_size = int(arg)
        elif opt == "-E":
            encoder_ckpt = arg
        elif opt == "--device":
            device = arg
    device = check_device(device)
    set_numerics_policy()

    rows: List[Dict] = []
    failed: List[str] = []

    def run(name: str, evaluate) -> None:
        try:
            metrics = evaluate()
        except Exception as e:  # noqa: BLE001 — reported, counted, and the exit code says so
            print(f"{name}: FAILED: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
            failed.append(name)
            return
        rows.append({"Name": os.path.basename(name), **metrics})
        print(name, metrics, flush=True)

    pths = sorted(glob.glob(os.path.join(runs_dir, "*.pth")))
    if pths and not arch:
        print("found .pth weights — pass -a <mdn|nf|recon> to evaluate them too")
    elif pths:
        for pth in pths:
            run(pth, lambda pth=pth: validate_pth(pth, model_name, arch, data_root, test_pref,
                                                  img_size, flow_steps=flow_steps,
                                                  encoder_ckpt=encoder_ckpt, device=device))
    for run_dir in sorted(glob.glob(os.path.join(runs_dir, "*"))):
        if os.path.exists(os.path.join(run_dir, "config.json")):
            run(run_dir, lambda run_dir=run_dir: validate_run(run_dir, data_root, test_pref,
                                                              device))
    if rows:
        out = os.path.join(runs_dir, "validation_results.csv")
        keys = sorted({k for r in rows for k in r})
        with open(out, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(rows)
        print("wrote", out)
    if failed:
        print(f"{len(failed)} of {len(failed) + len(rows)} failed: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    if not rows:
        print(f"nothing to validate under {runs_dir!r}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
