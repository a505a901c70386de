"""Export a port run directory to the reference's torch `.pth` files (port of
`vit_ad_tpu/cli/export_weights.py`). The port's checkpoints are already in
the reference layouts (`cli/common.py`), so the export selects a run's
files, names them as the JAX exporter names them, and writes them after a
strict load of every file into the run's models:

    python -m vit_ad_tpu_torch.cli.export_weights --run runs/<name> --dst head.pth

  * mdn, nf (frozen trunk): the head, one file at `--dst`: the reference
    GaussianMixtureDensityNetwork layout, or the NormalizingFlow
    `fast_flow_decoder.module_list.*` FrEIA layout with its `layer_norm`;
  * mdn, nf on the ResNet stage maps: `--dst` is a directory holding
    `{K}_stage{i}_{class}.pth` per MDN stage head (2, 3; the reference's
    validate_mdn_resnet parses them, validation_loop.py:91-95) or
    `NormalizingFlow_{i}_{class}.pth` per flow (0-2), and
    `ResNetEncoder_{class}.pth`, the encoder with its trained stage norms;
  * reconstruction: the whole auto-encoder (vanilla CNN, ResNet with its
    zeroed classifier `fc`, or a transformer trunk under its family's name).

Refused with exit code 2, as in the JAX CLI: `ae_eff_net` (no reference
format), a `.pth` `--dst` for a multi-stage run, a run without checkpoints,
an architecture without a reference format (`vae`, ...). A JAX run
directory (orbax params) is refused too: its own exporter,
`python -m vit_ad_tpu.cli.export_weights`, reads it. Runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Tuple


def export_files(run_dir: str, dst: str) -> List[Tuple[str, str]]:
    """(source checkpoint, destination path) pairs of a run's export, after
    every checkpoint strict-loaded into the run's models. Raises ValueError
    for a run this CLI refuses."""
    from vit_ad_tpu_torch.pipeline.loading import (
        build_run_models,
        find_checkpoint,
        load_run_config,
    )
    from vit_ad_tpu_torch.pipeline.train import NF_RESNET_STAGES, RESNET_MDN_STAGES

    hp, cfg = load_run_config(run_dir)
    arch, name = hp.architecture, hp.model_name
    if arch not in ("mdn", "nf", "reconstruction"):
        raise ValueError(f"architecture {arch!r} has no reference .pth head format "
                         "(exportable: mdn, nf, reconstruction)")
    if arch == "reconstruction" and not name.startswith(
            ("ae_res_net", "ae_cnn", "ae_deit", "ae_vit", "ae_nest", "ae_esvit",
             "ae_eff_former")):
        raise ValueError(f"recon export supports the vanilla AE, the ResNet AEs, and all five "
                         f"transformer AE families; got {name!r} (ae_eff_net has no reference "
                         "legacy format)")
    try:
        ckpts = find_checkpoint(run_dir, cfg)
    except (FileNotFoundError, SystemExit) as e:
        raise ValueError(str(e)) from None
    build_run_models(hp, ckpts)  # strict loads, or raise
    if arch in ("mdn", "nf") and "res_net" in name:
        if dst.endswith(".pth"):
            raise ValueError("multi-stage ResNet runs export several files; pass an output "
                             "DIRECTORY as --dst")
        dataclass = hp.data_class or "run"
        stages = RESNET_MDN_STAGES if arch == "mdn" else NF_RESNET_STAGES
        names = [f"{hp.num_gaussians}_stage{i}_{dataclass}.pth" if arch == "mdn"
                 else f"NormalizingFlow_{i}_{dataclass}.pth" for i in stages]
        names.append(f"ResNetEncoder_{dataclass}.pth")
        if len(ckpts) != len(names):
            raise ValueError(f"{run_dir}: {len(ckpts)} checkpoints, a multi-stage {arch} run "
                             f"has {len(names)}")
        return [(src, os.path.join(dst, n)) for src, n in zip(ckpts, names)]
    return [(ckpts[0], dst)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run", required=True,
                    help="a port run directory (config.json and its checkpoints)")
    ap.add_argument("--dst", required=True,
                    help="output .pth (a directory for a multi-stage ResNet run)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    from vit_ad_tpu_torch.pipeline.loading import load_pth
    from vit_ad_tpu_torch.utils.checkpoint import save_params

    try:
        pairs = export_files(args.run, args.dst)
    except (ValueError, KeyError, RuntimeError, OSError) as e:
        print(f"export_weights: {e}", file=sys.stderr)
        return 2
    for src, path in pairs:
        sd = load_pth(src)
        save_params(os.path.dirname(os.path.abspath(path)), os.path.basename(path), sd)
        print(f"exported {os.path.basename(src)} ({len(sd)} tensors) -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
