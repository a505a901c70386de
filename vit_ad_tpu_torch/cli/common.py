"""Shared CLI plumbing of the port's trainers (port of
`vit_ad_tpu/cli/common.py`: `parse_args` :44, `build_pipelines` :137,
`save_loss_curves` :170), and `run_trainer`, the body the trainer CLIs share.

The reference's flag surface (reference startTraining_mdn.py:40):

  -m model  -p patience  -e epochs  -a amountData  -l learnRate
  -w weightDecay  -b batchSize  -d dataPath  -t trainPref  -v validPref
  -i imageSize  -s blockIndex  --centering;  MDN adds -n numGaussians,
  NF adds -r hiddenRatio -f flowSteps

plus the port's `--device` (default cuda; without a card the CLI exits
unless `--device cpu` is given), `--out` (the run directory, default
`runs/<run name>`) and `--fused-ln` / `--no-fused-ln` (the trunk's LayerNorms
through the one-pass kernel or not) and `--fused-mlp` / `--no-fused-mlp` (the
ViT/DeiT blocks' MLP tail through the fused kernel or not; default of both:
the model's), and `--mesh <DxM|auto>` (JAX :56-82): train as the ranks of a
(data, model) mesh (`parallel/`). Inside an explicit cluster (the
`VITAD_COORDINATOR`, `VITAD_NUM_PROCESSES`, `VITAD_PROCESS_ID` variables) the
process is one rank; without one the CLI spawns the D·M ranks itself, one
card each (`parallel/launch.launch_cli`; on the CPU under `--device cpu`).
The primary rank alone writes the run directory.

The run directory is the JAX package's (`utils/logging.MetricLogger`):
  config.json      `HyperParams.to_log_dict()` and `checkpoints`, the weight
                   files in load order (`pipeline/loading.find_checkpoint`)
  metrics.jsonl    one record per epoch, then the metrics ("stage": "eval")
  metrics.csv      the same rows' scalars
  history.json     epoch losses and times, metrics, best epoch
  loss_curves.png  train and validation loss per epoch
  figures/         the evaluator's six figures (`pipeline/eval.save_eval_figures`)
  *.pth            the checkpoints, in the reference layouts `cli.score --pth`
                   reads; `cli.score -r` reads the directory
"""

from __future__ import annotations

import getopt
import json
import os
import warnings
from typing import Callable, Dict, List, Optional, Tuple

from vit_ad_tpu_torch.config import HyperParams, MeshConfig, check_device
from vit_ad_tpu_torch.data.loader import DataPipeline
from vit_ad_tpu_torch.parallel.multihost import barrier, host_snapshot, is_primary

BTAD_BASE = "data/btad/BTech_Dataset_transformed/01"
MVTEC_BASE = "data/mvtec_anomaly_detection/hazelnut"
USAGE = ("usage: -m <modelType> -p <patience> -e <#epochs> -a <amountOfData> -l <learnRate> "
         "-w <weightDecay> -b <batchSize> -d <dataPath> -t <trainPref> -i <imageSize> "
         "-v <validPref> -s <blockIndex> --centering --mesh <DxM|auto> --device <cuda|cpu> "
         "--out <runDir> --fused-ln|--no-fused-ln --fused-mlp|--no-fused-mlp")


def derive_dataset_names(data_path: str) -> Tuple[str, str]:
    """(dataset, dataclass) from the path, reference-style with a fallback."""
    parts = [p for p in data_path.split("/") if p]
    if "btad" in parts:
        i = parts.index("btad")
        return "btad", parts[i + 2] if len(parts) > i + 2 else parts[-1]
    if len(parts) >= 3:
        return parts[1], parts[2]
    return parts[0] if parts else "dataset", parts[-1] if parts else "class"


def parse_args(argv: List[str], hp: HyperParams, data_path: str, train_pref: str,
               test_pref: str, extra_short: str = "", usage_extra: str = ""
               ) -> Optional[Tuple[HyperParams, str, str, str, str, str]]:
    """Reference-style flags → (hp, data_path, train_pref, test_pref, device,
    out_dir); None when -h printed the usage. A process the environment names
    a rank of a cluster joins it first (before the device is chosen)."""
    from vit_ad_tpu_torch.parallel.multihost import maybe_initialize_distributed

    maybe_initialize_distributed()
    opts, _ = getopt.getopt(argv, "hm:p:e:a:l:w:b:s:d:i:v:t:" + extra_short,
                            ["centering", "mesh=", "device=", "out=", "fused-ln",
                             "no-fused-ln", "fused-mlp", "no-fused-mlp"])
    device, out_dir = "cuda", ""
    for opt, arg in opts:
        if opt == "-h":
            print(USAGE + usage_extra)
            return None
        if opt == "--mesh":
            hp.mesh = MeshConfig.parse(arg)
        elif opt == "--centering":
            hp.centering = True
        elif opt in ("--fused-ln", "--no-fused-ln"):
            hp.fused_ln = opt == "--fused-ln"
        elif opt in ("--fused-mlp", "--no-fused-mlp"):
            hp.fused_mlp = opt == "--fused-mlp"
        elif opt == "--device":
            device = arg
        elif opt == "--out":
            out_dir = arg
        elif opt == "-p":
            hp.patience = int(arg)
        elif opt == "-e":
            hp.epochs = int(arg)
        elif opt == "-a":
            hp.amount_data = int(arg)
        elif opt == "-l":
            hp.learning_rate = float(arg)
        elif opt == "-w":
            hp.weight_decay = float(arg)
        elif opt == "-b":
            hp.batch_size = int(arg)
        elif opt == "-d":
            data_path = arg
        elif opt == "-t":
            train_pref = arg
        elif opt == "-i":
            hp.img_size = int(arg)
        elif opt == "-m":
            hp.model_name = arg.lower()
        elif opt == "-v":
            test_pref = arg
        elif opt == "-n":
            hp.num_gaussians = int(arg)
        elif opt == "-s":
            hp.block_index = int(arg)
        elif opt == "-r":
            hp.hidden_ratio = float(arg)
        elif opt == "-f":
            hp.flow_steps = int(arg)
    if not hp.model_name.startswith(("enc_", "ae_")):  # -m deit means the registry's enc_deit
        hp.model_name = f"enc_{hp.model_name}"
    if hp.block_index and hp.model_name not in ("enc_deit", "enc_vit"):
        # only the ViT family extracts features at a truncated depth (the
        # reference's BLOCK_INDEX_DEIT trick, reference
        # src/pipeline/LearnerNF.py:18); the others ignore block_index
        warnings.warn(
            f"-s {hp.block_index} has no effect on {hp.model_name!r}: block "
            "truncation is implemented for enc_deit/enc_vit only (parity "
            "with the reference's DeiT-only BLOCK_INDEX trick); the full-"
            "depth features will be used",
            stacklevel=2,
        )
    hp.base_path = data_path
    hp.train_pref = train_pref
    hp.dataset, hp.data_class = derive_dataset_names(data_path)
    return hp, data_path, train_pref, test_pref, check_device(device), out_dir


def build_pipelines(hp: HyperParams, data_path: str, train_pref: str, test_pref: str
                    ) -> Tuple[DataPipeline, DataPipeline]:
    """The training split (80/20 train/valid) and the labelled test set."""
    data = DataPipeline(hp.batch_size, hp.img_size, base_path=data_path, data_path=train_pref,
                        amount_data=hp.amount_data)
    test = DataPipeline(hp.batch_size, hp.img_size, base_path=data_path, data_path=test_pref,
                        validation_mode=True)
    return data, test


def head_checkpoints(result, hp: HyperParams, pth_name: str) -> Dict[str, Dict]:
    """File name → state dict of a frozen-trunk run: the best head (of a
    recon run, the whole auto-encoder), a mesh run's in the full layout (every
    rank gathers it)."""
    return {f"{pth_name}_{hp.data_class}.pth": host_snapshot(result.head)}


def resnet_checkpoints(result, hp: HyperParams, pth_name: str) -> Dict[str, Dict]:
    """File name → state dict of a ResNet multi-stage run, in load order: one
    file per stage head (`<pth_name>_stage<i>_<class>.pth`: the MDN heads of
    stages 2 and 3, which `cli.score --pth` takes in stage order, or the
    flows of stages 0-2, as the JAX `export_weights` names them), then the
    encoder with its trained stage norms and the trunk's BatchNorm statistics
    (`ResNetEncoder_<class>.pth`, the `-E` of `cli.score --pth`)."""
    from vit_ad_tpu_torch.pipeline.train import NF_RESNET_STAGES, RESNET_MDN_STAGES

    stages = RESNET_MDN_STAGES if hp.architecture == "mdn" else NF_RESNET_STAGES
    out = {f"{pth_name}_stage{i}_{hp.data_class}.pth": host_snapshot(head)
           for i, head in zip(stages, result.head)}
    out[f"ResNetEncoder_{hp.data_class}.pth"] = host_snapshot(result.encoder)
    return out


def save_loss_curves(logger, history: Dict) -> Optional[str]:
    """`loss_curves.png` in the run directory, registered with the logger."""
    if not history.get("train_loss"):
        return None
    from vit_ad_tpu_torch.utils.images import plot_loss_curves, save_png

    path = save_png(plot_loss_curves(history), os.path.join(logger.dir, "loss_curves.png"))
    logger.log_figure("loss_curves", path)
    return path


def run_trainer(parsed: Tuple[HyperParams, str, str, str, str, str], trainer: Callable,
                banner: str, run_name: str, pth_name: str,
                checkpoints: Callable = head_checkpoints) -> int:
    """What the trainer CLIs do with their parsed flags: build the registry
    model (seed-deterministic init, as in the JAX package's trainers: the
    trunk, or for a reconstruction run the whole auto-encoder, which the
    trainer takes as `model`) and the pipelines, train, print the metrics,
    and write the run directory (`--out`, default
    `<log_dir>/<run_name>_<dataset>_<class>`; the files are the module
    docstring's): the checkpoints are `checkpoints(result, hp, pth_name)`, by
    default the best head's state dict as `<pth_name>_<class>.pth`. `banner`
    and the two names are format strings over the hyper-parameters. On a mesh
    every rank trains and gathers the checkpoints; the primary alone prints
    and writes (the other ranks open no file in the run directory), and the
    ranks return together once it has."""
    from vit_ad_tpu_torch.config import set_numerics_policy
    from vit_ad_tpu_torch.pipeline.train import default_encoder
    from vit_ad_tpu_torch.utils.checkpoint import save_params
    from vit_ad_tpu_torch.utils.logging import MetricLogger

    hp, data_path, train_pref, test_pref, device, out_dir = parsed
    try:
        model = default_encoder(hp)
    except (KeyError, NotImplementedError, ValueError) as e:
        raise SystemExit(f"-m {hp.model_name}: {e}") from None
    # a recon run trains the registry's auto-encoder itself, the other
    # trainers a head on the registry trunk
    model_arg = {"model": model} if hp.architecture == "reconstruction" else {"encoder": model}
    set_numerics_policy()
    data, test = build_pipelines(hp, data_path, train_pref, test_pref)
    fields = vars(hp)
    out_dir = os.path.abspath(out_dir or os.path.join(
        hp.log_dir, f"{run_name.format(**fields)}_{hp.dataset}_{hp.data_class}"))
    config = hp.to_log_dict()
    logger = None
    if is_primary():
        logger = MetricLogger(os.path.dirname(out_dir), run_name=os.path.basename(out_dir),
                              config=config, enable_wandb=hp.enable_wandb)
        print(f"{banner.format(**fields)}, patience {hp.patience}, epochs {hp.epochs}, "
              f"lr {hp.learning_rate}, wd {hp.weight_decay}, bs {hp.batch_size}, "
              f"img {hp.img_size}, data {data_path}/{train_pref}, device {device}", flush=True)
    try:
        result = trainer(hp, data, test, **model_arg, device=device,
                         log=logger and logger.log,
                         figures_dir=logger and os.path.join(logger.dir, "figures"),
                         logger=logger)
        states = checkpoints(result, hp, pth_name.format(**fields))
        if logger is None:
            barrier()
            return 0
        print("final metrics:", json.dumps(result.metrics))
        with open(os.path.join(out_dir, "history.json"), "w") as f:
            json.dump({**result.history, "metrics": result.metrics,
                       "epochs_ran": result.epochs_ran, "best_epoch": result.best_epoch,
                       "best_valid_loss": result.best_valid_loss}, f, indent=1)
        save_loss_curves(logger, result.history)
        names = []
        for name, state in states.items():
            path = save_params(out_dir, name, state)
            logger.log_artifact(path)
            names.append(name)
            print("checkpoint:", path)
        logger.write_config({**config, "checkpoints": names})
    finally:
        if logger is not None:
            logger.finish()
    barrier()
    return 0
