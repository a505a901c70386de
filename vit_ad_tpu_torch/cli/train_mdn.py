"""Train an MDN/GMM anomaly head on frozen-trunk features on the GPU.

Port of `startTraining_mdn.py` (the flag surface of `cli/common.py`, with
`-n <numGaussians>`; defaults: model deit, patience 100, epochs 1000, lr 7e-4,
wd 7e-4, batch 64, K 150, 224 px — reference startTraining_mdn.py:26-38):

    python -m vit_ad_tpu_torch.cli.train_mdn -d <category dir> -t train/good \\
        -v test [-m deit] [-n 150] [-e EPOCHS] [-b BATCH] [--device cuda|cpu] \\
        [--out RUN_DIR]

The trunk is the registry model with its seed-deterministic init, as in the
JAX package's trainer. Writes into the run directory (default
runs/mdn_<model>_<K>g_<dataset>_<class>):
  history.json                       epoch losses, metrics, best epoch
  <K>_gaussians_<model>_<class>.pth  the best head, in the reference
                                     GaussianMixtureDensityNetwork layout,
                                     which `cli.score --pth ... -a mdn` reads
The metric logger and wandb are ROADMAP A10; k-means init is ROADMAP A5.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from vit_ad_tpu_torch.cli.common import BTAD_BASE, build_pipelines, parse_args
from vit_ad_tpu_torch.config import HyperParams, set_numerics_policy


def main(argv=None) -> int:
    from vit_ad_tpu_torch.pipeline.train import default_encoder, train_mdn

    hp = HyperParams(model_name="enc_deit", architecture="mdn", patience=100, epochs=1000,
                     learning_rate=7e-4, weight_decay=7e-4, batch_size=64, num_gaussians=150,
                     img_size=224)
    parsed = parse_args(sys.argv[1:] if argv is None else argv, hp, BTAD_BASE, "train/ok",
                        "test", extra_short="n:", usage_extra=" -n <numGaussians>")
    if parsed is None:
        return 0
    hp, data_path, train_pref, test_pref, device, out_dir = parsed
    if not hp.model_name.startswith(("enc_", "ae_")):
        hp.model_name = f"enc_{hp.model_name}"
    try:
        encoder = default_encoder(hp)
    except (KeyError, NotImplementedError) as e:
        raise SystemExit(f"-m {hp.model_name}: {e}") from None
    set_numerics_policy()
    data, test = build_pipelines(hp, data_path, train_pref, test_pref)
    out_dir = out_dir or os.path.join(
        hp.log_dir, f"mdn_{hp.model_name}_{hp.num_gaussians}g_{hp.dataset}_{hp.data_class}")
    os.makedirs(out_dir, exist_ok=True)
    print(f"Training MDN: model {hp.model_name}, K {hp.num_gaussians}, patience {hp.patience}, "
          f"epochs {hp.epochs}, lr {hp.learning_rate}, wd {hp.weight_decay}, "
          f"bs {hp.batch_size}, img {hp.img_size}, data {data_path}/{train_pref}, "
          f"device {device}", flush=True)
    result = train_mdn(hp, data, test, encoder=encoder, device=device,
                       log=lambda row: print(json.dumps(row), flush=True))
    print("final metrics:", json.dumps(result.metrics))
    with open(os.path.join(out_dir, "history.json"), "w") as f:
        json.dump({**result.history, "metrics": result.metrics,
                   "epochs_ran": result.epochs_ran, "best_epoch": result.best_epoch,
                   "best_valid_loss": result.best_valid_loss}, f, indent=1)
    pth = os.path.join(out_dir, f"{hp.num_gaussians}_gaussians_{hp.model_name}_"
                                f"{hp.data_class}.pth")
    torch.save({k: v.detach().cpu() for k, v in result.head.state_dict().items()}, pth)
    print("checkpoint:", pth)
    return 0


if __name__ == "__main__":
    sys.exit(main())
