"""Train a reconstruction (auto-encoder) anomaly model on the GPU.

Port of `startTraining_recon.py` (the flag surface of `cli/common.py`;
defaults: model ae_cnn, patience 30, epochs 50, lr 1e-3, wd 1e-4, batch 64,
224 px — reference startTraining_recon.py:27-38):

    python -m vit_ad_tpu_torch.cli.train_recon -d <category dir> -t train/good \\
        -v test [-m ae_cnn|ae_deit|ae_vit|ae_esvit|ae_nest|ae_eff_former|ae_*_small \\
        |ae_res_net|ae_res_net_small] [-e EPOCHS] [-b BATCH] [-i IMG] \\
        [--device cuda|cpu] [--out RUN_DIR] [--fused-ln|--no-fused-ln] \\
        [--fused-mlp|--no-fused-mlp]

The auto-encoder is the registry model with its seed-deterministic init, as
in the JAX package's trainer: the vanilla AE trains end to end, the others
train the decoder on their frozen encoder (a transformer trunk runs once
over the batches: the latent cache). The loss is the MSE, as the JAX CLI
trains it. Writes the run directory (default
runs/recon_<model>_<dataset>_<class>; its files: `cli/common.py`, the figures
with the recon grid), which `cli.score -r` reads, with the checkpoint
  <model>_<class>.pth   the whole auto-encoder with its best weights, in the
                        reference's layout, which `cli.score --pth ... -a recon
                        -m <model>` reads
"""

from __future__ import annotations

import sys

from vit_ad_tpu_torch.cli.common import MVTEC_BASE, parse_args, run_trainer
from vit_ad_tpu_torch.config import HyperParams
from vit_ad_tpu_torch.parallel.launch import launch_cli


def main(argv=None) -> int:
    from vit_ad_tpu_torch.pipeline.train import train_recon

    hp = HyperParams(model_name="ae_cnn", architecture="reconstruction", patience=30, epochs=50,
                     learning_rate=1e-3, weight_decay=1e-4, batch_size=64, img_size=224)
    argv = sys.argv[1:] if argv is None else argv
    parsed = parse_args(argv, hp, MVTEC_BASE, "train/good",
                        "test")
    if parsed is None:
        return 0
    launched = launch_cli("vit_ad_tpu_torch.cli.train_recon", argv, parsed[0].mesh, parsed[4])
    if launched is not None:
        return launched
    if not parsed[0].model_name.startswith("ae_"):
        raise SystemExit(f"-m {parsed[0].model_name}: the recon trainer takes an auto-encoder "
                         "key (ae_*)")
    return run_trainer(parsed, train_recon, banner="Training recon: model {model_name}",
                       run_name="recon_{model_name}", pth_name="{model_name}")


if __name__ == "__main__":
    sys.exit(main())
