"""Checkpoint conversion CLI: an upstream trunk `.pth` → the port's encoder
file (port of `vit_ad_tpu/cli/convert_weights.py`; the reference downloads
timm and torchvision checkpoints when it builds a model, reference
TransformerEncoder.py:134, CnnEncoder.py:141-145, and here conversion is an
explicit step that fails at once on a layout it does not know):

    python -m vit_ad_tpu_torch.cli.convert_weights \\
        --arch deit --src deit_base_distilled_patch16_224.pth --dst ckpt/deit
    python -m vit_ad_tpu_torch.cli.convert_weights --arch resnet50 --src resnet50.pth \\
        --dst ckpt/rn50
    python -m vit_ad_tpu_torch.cli.convert_weights --arch esvit \\
        --src checkpoint_best.pth --dst ckpt/esvit

The file goes through the port's loader (`pipeline/loading.load_pth` and
`load_encoder_state`): the EsViT `student` container unwrapped, the
`module.` prefix stripped, `distillation_token` renamed `dist_token`, the
classifier heads dropped, the Swin checkpoint surgery, and either ResNet
layout (torchvision's, or the reference encoder's with its stage norms).
The result strict-loads into the matching registry encoder, whose state dict
is written as `<dst>/encoder.pth` (`utils/checkpoint.save_params`). `cli.score
-E <dst>` reads that directory, as does `load_encoder_params`. Runs on the
CPU; no card is needed.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

# registry model key → converter arch (as the JAX CLI's table)
MODEL_ARCH = {
    "enc_deit": "deit",
    "enc_vit": "vit",
    "enc_esvit": "esvit",
    "enc_nest": "nest",
    "enc_eff_former": "efficientformer",
    "enc_eff_net": "efficientnet",
    "enc_res_net": "resnet50",
    "res_net": "resnet50",
}
# converter arch → the registry encoder it loads into
ARCH_MODEL = {arch: key for key, arch in MODEL_ARCH.items() if key.startswith("enc_")}


def convert_state_dict(arch: str, sd, img_size: int = 224) -> torch.nn.Module:
    """The registry encoder of `arch` (at `img_size`) with the unwrapped
    state dict `sd` loaded strictly after the port's checkpoint surgery."""
    from vit_ad_tpu_torch.pipeline.loading import load_encoder_state
    from vit_ad_tpu_torch.registry import get_model

    if arch not in ARCH_MODEL:
        raise SystemExit(f"unknown arch {arch!r} ({'|'.join(sorted(ARCH_MODEL))})")
    encoder = get_model(ARCH_MODEL[arch], img_size, generator=torch.Generator().manual_seed(0))
    return load_encoder_state(encoder, sd)


def convert(arch: str, src: str, dst: str, img_size: int = 224) -> str:
    """`src` → `<dst>/encoder.pth`; returns the path."""
    from vit_ad_tpu_torch.pipeline.loading import CONVERTED_ENCODER, load_pth
    from vit_ad_tpu_torch.utils.checkpoint import save_params

    encoder = convert_state_dict(arch, load_pth(src), img_size)
    path = save_params(dst, CONVERTED_ENCODER, encoder.state_dict())
    print(f"converted {arch} weights → {path}")
    return path


def load_encoder_params(arch_dir: str, encoder: torch.nn.Module) -> torch.nn.Module:
    """Load what this CLI wrote (its directory or the file) into `encoder`
    strictly; returns it."""
    from vit_ad_tpu_torch.pipeline.loading import load_encoder_checkpoint

    return load_encoder_checkpoint(encoder, arch_dir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCH_MODEL))
    ap.add_argument("--src", required=True, help="upstream torch .pth checkpoint")
    ap.add_argument("--dst", required=True, help="output directory")
    ap.add_argument("--img-size", type=int, default=224)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.dst.endswith(".pth") or os.path.isfile(args.dst):
        raise SystemExit(f"--dst {args.dst}: an output directory (encoder.pth is written "
                         "into it)")
    convert(args.arch, args.src, args.dst, args.img_size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
