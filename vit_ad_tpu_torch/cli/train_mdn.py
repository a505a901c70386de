"""Train an MDN/GMM anomaly head on the GPU: on frozen-trunk features, or
(`-m res_net`) two stage heads jointly with the ResNet-50's stage LayerNorms.

Port of `startTraining_mdn.py` (the flag surface of `cli/common.py`, with
`-n <numGaussians>`; defaults: model deit, patience 100, epochs 1000, lr 7e-4,
wd 7e-4, batch 64, K 150, 224 px — reference startTraining_mdn.py:26-38):

    python -m vit_ad_tpu_torch.cli.train_mdn -d <category dir> -t train/good \\
        -v test [-m deit|vit|esvit|nest|eff_former|eff_net|res_net] [-n 150] \\
        [-e EPOCHS] [-b BATCH] [--device cuda|cpu] [--out RUN_DIR] \\
        [--fused-ln|--no-fused-ln] [--fused-mlp|--no-fused-mlp]

The trunk is the registry model with its seed-deterministic init, as in the
JAX package's trainer. Writes the run directory (default
runs/mdn_<model>_<K>g_<dataset>_<class>; its files: `cli/common.py`), which
`cli.score -r` reads, with the checkpoint
  <K>_gaussians_<model>_<class>.pth  the best head, in the reference
                                     GaussianMixtureDensityNetwork layout,
                                     which `cli.score --pth ... -a mdn` reads
With `-m res_net` (reference startTraining_mdn.py:134-147, the JAX CLI's
dispatch to `train_mdn_resnet`) the checkpoints are instead
  <K>_gaussians_enc_res_net_stage2_<class>.pth, ..._stage3_<class>.pth
                                     the heads on stage maps 2 and 3
  ResNetEncoder_<class>.pth          the encoder with its trained stage norms
which `cli.score --pth <stage2> <stage3> -a mdn -E <encoder>` reads.
No flag sets `HyperParams.kmeans_init`, as in the JAX CLI: `pipeline.train.train_mdn`
takes it from the caller's hyper-parameters.
"""

from __future__ import annotations

import sys

from vit_ad_tpu_torch.cli.common import (
    BTAD_BASE,
    head_checkpoints,
    parse_args,
    resnet_checkpoints,
    run_trainer,
)
from vit_ad_tpu_torch.config import HyperParams
from vit_ad_tpu_torch.parallel.launch import launch_cli


def main(argv=None) -> int:
    from vit_ad_tpu_torch.pipeline.train import train_mdn, train_mdn_resnet

    hp = HyperParams(model_name="enc_deit", architecture="mdn", patience=100, epochs=1000,
                     learning_rate=7e-4, weight_decay=7e-4, batch_size=64, num_gaussians=150,
                     img_size=224)
    argv = sys.argv[1:] if argv is None else argv
    parsed = parse_args(argv, hp, BTAD_BASE, "train/ok",
                        "test", extra_short="n:", usage_extra=" -n <numGaussians>")
    if parsed is None:
        return 0
    launched = launch_cli("vit_ad_tpu_torch.cli.train_mdn", argv, parsed[0].mesh, parsed[4])
    if launched is not None:
        return launched
    resnet = "res_net" in parsed[0].model_name
    return run_trainer(parsed, train_mdn_resnet if resnet else train_mdn,
                       banner="Training MDN: model {model_name}, K {num_gaussians}",
                       run_name="mdn_{model_name}_{num_gaussians}g",
                       pth_name="{num_gaussians}_gaussians_{model_name}",
                       checkpoints=resnet_checkpoints if resnet else head_checkpoints)


if __name__ == "__main__":
    sys.exit(main())
