"""Train a normalizing-flow anomaly head on the GPU: on frozen-trunk features,
or (`-m res_net`) three stage flows jointly with the ResNet-50's stage
LayerNorms.

Port of `startTraining_NF.py` (the flag surface of `cli/common.py`, with
`-r <hiddenRatio> -f <flowSteps>`; defaults: model deit, patience 60, epochs
500, lr 1e-3, wd 1e-5, batch 32, hidden ratio 0.16, 20 flow steps, 224 px —
reference startTraining_NF.py:26-39):

    python -m vit_ad_tpu_torch.cli.train_nf -d <category dir> -t train/good \\
        -v test [-m deit|vit|esvit|nest|eff_former|eff_net|res_net] [-r 0.16] [-f 20] \\
        [-e EPOCHS] [-b BATCH] \\
        [--device cuda|cpu] [--out RUN_DIR] [--fused-ln|--no-fused-ln] \\
        [--fused-mlp|--no-fused-mlp]

The trunk is the registry model with its seed-deterministic init, as in the
JAX package's trainer. Writes the run directory (default
runs/nf_<model>_<dataset>_<class>; its files: `cli/common.py`) with the
checkpoint
  nf_<model>_<class>.pth     the best head, in the reference's FrEIA layout,
                             which `cli.score --pth ... -a nf` reads
With `-m res_net` (reference startTraining_NF.py:139-152, the JAX CLI's
dispatch to `train_nf_resnet`) the checkpoints are instead
  nf_enc_res_net_stage{0,1,2}_<class>.pth   the flows on stage maps 0-2
  ResNetEncoder_<class>.pth                 the encoder with its trained
                                            stage norms
which `cli.score -r <run dir>` reads (as in the JAX package, no `--pth`
convention scores this head).
"""

from __future__ import annotations

import sys

from vit_ad_tpu_torch.cli.common import (
    MVTEC_BASE,
    head_checkpoints,
    parse_args,
    resnet_checkpoints,
    run_trainer,
)
from vit_ad_tpu_torch.config import HyperParams
from vit_ad_tpu_torch.parallel.launch import launch_cli


def main(argv=None) -> int:
    from vit_ad_tpu_torch.pipeline.train import train_nf, train_nf_resnet

    hp = HyperParams(model_name="enc_deit", architecture="nf", patience=60, epochs=500,
                     learning_rate=1e-3, weight_decay=1e-5, batch_size=32, hidden_ratio=0.16,
                     flow_steps=20, img_size=224)
    argv = sys.argv[1:] if argv is None else argv
    parsed = parse_args(argv, hp, MVTEC_BASE, "train/good",
                        "test", extra_short="r:f:",
                        usage_extra=" -r <hiddenRatio> -f <flowSteps>")
    if parsed is None:
        return 0
    launched = launch_cli("vit_ad_tpu_torch.cli.train_nf", argv, parsed[0].mesh, parsed[4])
    if launched is not None:
        return launched
    resnet = "res_net" in parsed[0].model_name
    return run_trainer(parsed, train_nf_resnet if resnet else train_nf,
                       banner="Training NF: model {model_name}, hidden_ratio {hidden_ratio}, "
                              "flow_steps {flow_steps}",
                       run_name="nf_{model_name}", pth_name="nf_{model_name}",
                       checkpoints=resnet_checkpoints if resnet else head_checkpoints)


if __name__ == "__main__":
    sys.exit(main())
