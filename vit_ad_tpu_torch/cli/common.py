"""Shared CLI plumbing of the port's trainers (port of
`vit_ad_tpu/cli/common.py`: `parse_args` :44, `build_pipelines` :137).

The reference's flag surface (reference startTraining_mdn.py:40):

  -m model  -p patience  -e epochs  -a amountData  -l learnRate
  -w weightDecay  -b batchSize  -d dataPath  -t trainPref  -v validPref
  -i imageSize  -s blockIndex  --centering;  MDN adds -n numGaussians

plus the port's `--device` (default cuda; without a card the CLI exits
unless `--device cpu` is given) and `--out` (the run directory). `--mesh`
is ROADMAP A11 and exits with a message.
"""

from __future__ import annotations

import getopt
from typing import List, Optional, Tuple

import torch

from vit_ad_tpu_torch.config import HyperParams
from vit_ad_tpu_torch.data.loader import DataPipeline

BTAD_BASE = "data/btad/BTech_Dataset_transformed/01"
USAGE = ("usage: -m <modelType> -p <patience> -e <#epochs> -a <amountOfData> -l <learnRate> "
         "-w <weightDecay> -b <batchSize> -d <dataPath> -t <trainPref> -i <imageSize> "
         "-v <validPref> -s <blockIndex> --centering --device <cuda|cpu> --out <runDir>")


def derive_dataset_names(data_path: str) -> Tuple[str, str]:
    """(dataset, dataclass) from the path, reference-style with a fallback."""
    parts = [p for p in data_path.split("/") if p]
    if "btad" in parts:
        i = parts.index("btad")
        return "btad", parts[i + 2] if len(parts) > i + 2 else parts[-1]
    if len(parts) >= 3:
        return parts[1], parts[2]
    return parts[0] if parts else "dataset", parts[-1] if parts else "class"


def check_device(device: str) -> str:
    """The requested device, or exit: a CUDA device without a card is an
    error, never a quiet fall back to the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {device}: no CUDA device is available; give --device cpu "
                         "explicitly to run on the CPU")
    return device


def parse_args(argv: List[str], hp: HyperParams, data_path: str, train_pref: str,
               test_pref: str, extra_short: str = "", usage_extra: str = ""
               ) -> Optional[Tuple[HyperParams, str, str, str, str, str]]:
    """Reference-style flags → (hp, data_path, train_pref, test_pref, device,
    out_dir); None when -h printed the usage."""
    opts, _ = getopt.getopt(argv, "hm:p:e:a:l:w:b:s:d:i:v:t:" + extra_short,
                            ["centering", "mesh=", "device=", "out="])
    device, out_dir = "cuda", ""
    for opt, arg in opts:
        if opt == "-h":
            print(USAGE + usage_extra)
            return None
        if opt == "--mesh":
            raise SystemExit("--mesh is not ported to vit_ad_tpu_torch yet (ROADMAP A11)")
        if opt == "--centering":
            hp.centering = True
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
