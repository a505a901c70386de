"""Rebuild live models from reference-format `.pth` checkpoints (port of the
legacy-checkpoint half of `vit_ad_tpu/pipeline/loading.py`; run directories
hold orbax checkpoints and are ROADMAP A10).

Every `.pth` is read with `torch.load(weights_only=True)`: tensors only, no
pickled code.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from vit_ad_tpu_torch.config import DtypePolicy, HyperParams
from vit_ad_tpu_torch.models.flow import NormalizingFlow
from vit_ad_tpu_torch.models.mdn import GaussianMDN
from vit_ad_tpu_torch.models.outputs import Encoder
from vit_ad_tpu_torch.models.resnet import STAGE_CHANNELS, ResNetEncoder
from vit_ad_tpu_torch.models.swin import SwinTransformer
from vit_ad_tpu_torch.registry import get_model
from vit_ad_tpu_torch.utils.convert import interpolate_rel_pos_table


@dataclass
class RunModels:
    """Live models for one head. `parts` is the positional model prefix the
    matching `pipeline.eval.score_*` function takes."""

    kind: str  # 'nf' | 'mdn' | 'mdn_resnet' | 'recon' in the ported slices
    hp: HyperParams
    parts: Tuple[Any, ...]


def parse_pth_filename(filename: str, arch: str):
    """Reference filename convention (validation_loop.py:38-41,92-95,163-166):
    MDN files lead with the gaussian count, every file ends with the data
    class; 'nut'/'metal' tails mean metal_nut. Returns (num_gaussians | None,
    dataclass)."""
    stem = os.path.basename(filename)
    stem = stem[:-4] if stem.endswith(".pth") else stem
    dataclass = stem.split("_")[-1]
    if dataclass in ("nut", "metal"):
        dataclass = "metal_nut"
    num_gaussians = None
    if arch == "mdn":
        lead = stem.split("_")[0]
        if not lead.isdigit():
            raise SystemExit(
                f"MDN .pth filenames must lead with the gaussian count (reference "
                f"convention '<K>_..._<dataclass>.pth'); got {os.path.basename(filename)!r}"
            )
        num_gaussians = int(lead)
    return num_gaussians, dataclass


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """A `.pth` state dict on the CPU, unwrapped from a {'state_dict'|'model':
    ...} container."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            return sd[key]
    return sd


def _swin_checkpoint_surgery(encoder: SwinTransformer, sd: Dict[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
    """The EsViT checkpoint surgery of the JAX `convert_swin` (:1118-1192) on
    a state dict without `module.` prefix and head: drop the lazily cached
    `attn_mask` buffers, recompute every `relative_position_index` (the
    encoder's own), and resize a relative-position bias table whose source
    window differs from the block's effective window (stage 3 at 224 px runs
    window 7 on a table saved for window 14)."""
    sd = {k: v for k, v in sd.items() if not k.endswith("attn_mask")}
    for name, buf in encoder.named_buffers():
        if name.endswith("relative_position_index"):
            sd[name] = buf
    for si, stage in enumerate(encoder.layers):
        for bj in range(len(stage.blocks)):
            key = f"layers.{si}.blocks.{bj}.attn.relative_position_bias_table"
            if key in sd:
                table = sd[key].float().numpy()
                src = int(round((table.shape[0] ** 0.5 + 1) / 2))
                sd[key] = torch.from_numpy(np.ascontiguousarray(
                    interpolate_rel_pos_table(table, src, stage.window)))
    return sd


def _resnet_encoder_state(encoder: ResNetEncoder, sd: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """A full `ResNetEncoder` state dict from either layout the JAX
    `convert_resnet_encoder` (:1379) and `convert_resnet50` (:159) read: the
    reference encoder's (`res_net.*` and, where saved, `norms.{i}.*`) or a
    bare torchvision ResNet-50. Entries a file does not hold (the stage norms
    of an ImageNet file, the unread classifier) keep the encoder's own."""
    if not any(k.startswith("res_net.") for k in sd):
        sd = {f"res_net.{k}": v for k, v in sd.items()}
    own = encoder.state_dict()
    unknown = sorted(set(sd) - set(own))
    if unknown:
        raise KeyError(f"unexpected keys in a ResNet encoder checkpoint: {unknown[:8]}")
    optional = {k: v for k, v in own.items()
                if k.startswith(("norms.", "res_net.fc.")) or k.endswith("num_batches_tracked")}
    return {**optional, **sd}


# buffers a checkpoint may lack or hold in another form, which the encoder
# makes itself: BatchNorm batch counts (never read) and EfficientFormer's
# attention-bias index, which the JAX `convert_efficientformer` recomputes
_OWN_BUFFERS = ("num_batches_tracked", "attention_bias_idxs")


def _with_own_buffers(module: torch.nn.Module, sd: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """`sd` with every `_OWN_BUFFERS` entry taken from `module` itself."""
    sd = {k: v for k, v in sd.items() if not k.endswith(_OWN_BUFFERS)}
    for name, buf in module.named_buffers():
        if name.endswith(_OWN_BUFFERS):
            sd[name] = buf
    return sd


def load_encoder_checkpoint(encoder: Encoder, encoder_ckpt: str) -> Encoder:
    """Load a pretrained trunk `.pth` into `encoder` strictly: a timm ViT/DeiT
    file, the EsViT Swin-T checkpoint for a `SwinTransformer`, a timm
    `jx_nest_tiny` or `efficientformer_l3` file, NVIDIA's widese-B4 file for
    an `EfficientNetEncoder`, or for a `ResNetEncoder` a torchvision
    ResNet-50 or a reference-layout encoder file. Strips a DataParallel
    `module.` prefix and drops the classifier heads (`head.*`, `head_dist.*`,
    `pre_logits.*`, `classifier.*`), as the JAX `convert_vit` (:122),
    `convert_swin` (:1118), `convert_nest` (:200), `convert_efficientformer`
    (:272) and `convert_efficientnet` (:365) do; the BatchNorm batch counts
    and EfficientFormer's `attention_bias_idxs` are the encoder's own, and
    the Swin file also gets `_swin_checkpoint_surgery`."""
    if not encoder_ckpt.endswith(".pth"):
        raise SystemExit(
            f"encoder checkpoint {encoder_ckpt!r}: the port reads .pth files; "
            "orbax checkpoint directories need jax (ROADMAP A10)"
        )
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in load_pth(encoder_ckpt).items()}
    if isinstance(encoder, ResNetEncoder):
        encoder.load_state_dict(_resnet_encoder_state(encoder, sd), strict=True)
        return encoder
    if "distillation_token" in sd:
        sd["dist_token"] = sd.pop("distillation_token")
    sd = {k: v for k, v in sd.items()
          if not k.startswith(("head.", "head_dist.", "pre_logits.", "classifier."))}
    sd = _with_own_buffers(encoder, sd)
    if isinstance(encoder, SwinTransformer):
        sd = _swin_checkpoint_surgery(encoder, sd)
    encoder.load_state_dict(sd, strict=True)
    return encoder


def _flow_decoder_state(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The AllInOneBlock entries of a reference NF state dict, rooted at
    `module_list.` (accepts the `fast_flow_decoder.` and legacy `nf.` roots
    and a bare SequenceINN save; the unused `layer_norm` member is dropped,
    as the JAX `convert_nf_head` drops it)."""
    out = {}
    for k, v in sd.items():
        for root in ("fast_flow_decoder.", "nf."):
            if k.startswith(root):
                k = k[len(root):]
                break
        if k.startswith("module_list."):
            out[k] = v
        elif not k.startswith("layer_norm."):
            raise KeyError(f"unexpected key {k!r} in a normalizing-flow state dict")
    return out


def build_pth_models(
    pth_path: str,
    model_name: str,
    arch: str,
    img_size: int = 224,
    hidden_ratio: float = 0.16,
    flow_steps: int = 20,
    encoder_ckpt: str = "",
    dtypes: Optional[DtypePolicy] = None,
    device: Optional[torch.device] = None,
    fused_ln: Optional[bool] = None,
    fused_mlp: Optional[bool] = None,
    block_index: int = 0,
) -> RunModels:
    """Encoder + NF or MDN head from a reference-format head `.pth` (MDN:
    K from the `<K>_..._<class>.pth` filename), or for `arch` "recon" the
    whole auto-encoder of `model_name` (an ae_* key) from its `.pth`
    (`_load_recon_model`). `encoder_ckpt` is the pretrained trunk the head
    was trained against (a timm or EsViT `.pth`); without it the encoder is
    the seed-random init (warned). `fused_ln` and `fused_mlp` are
    `registry.get_model`'s; `block_index` is the feature depth the head was
    trained on (`HyperParams.block_index`, 0 = the last block). The models
    are moved to `device` (default CPU) in eval mode."""
    if arch not in ("nf", "mdn", "recon"):
        raise NotImplementedError(f"legacy .pth scoring of arch {arch!r} is not ported; the "
                                  "port scores -a nf, -a mdn and -a recon")
    num_gaussians, dataclass = parse_pth_filename(pth_path, arch)
    hp = HyperParams(model_name=model_name, architecture=arch, img_size=img_size,
                     hidden_ratio=hidden_ratio, flow_steps=flow_steps,
                     num_gaussians=num_gaussians or 150, data_class=dataclass,
                     fused_ln=fused_ln, fused_mlp=fused_mlp, block_index=block_index)
    if dtypes is not None:
        hp.dtypes = dtypes
    encoder = get_model(hp.model_name, hp.img_size, hp.dtypes,
                        generator=torch.Generator().manual_seed(hp.seed), fused_ln=fused_ln,
                        fused_mlp=fused_mlp)
    if arch == "recon":  # `encoder` is the whole auto-encoder
        ae = _load_recon_model(encoder, pth_path, encoder_ckpt)
        return RunModels(kind="recon", hp=hp, parts=(ae.to(device).eval(),))
    if encoder_ckpt:
        load_encoder_checkpoint(encoder, encoder_ckpt)
    else:
        print(f"build_pth_models ({arch}): no encoder checkpoint given (-E) — "
              "evaluating against the seed-random trunk; reference-trained heads "
              "need their pretrained trunk weights for meaningful scores")
    if arch == "mdn":
        head = GaussianMDN(encoder.embed_dim, hp.num_gaussians, dtypes=hp.dtypes)
        head.load_state_dict(load_pth(pth_path), strict=True)
    else:
        head = NormalizingFlow(num_channels=encoder.embed_dim, img_size=hp.img_size,
                               num_patches=encoder.num_patches, hidden_ratio=hp.hidden_ratio,
                               flow_steps=hp.flow_steps)
        head.fast_flow_decoder.load_state_dict(_flow_decoder_state(load_pth(pth_path)),
                                               strict=True)
    return RunModels(kind=arch, hp=hp,
                     parts=(encoder.to(device).eval(), head.to(device).eval()))


def _load_recon_model(model: torch.nn.Module, pth_path: str, encoder_ckpt: str
                      ) -> torch.nn.Module:
    """A reference recon `.pth` is the whole auto-encoder's state dict (its
    frozen encoder included; reference TrainingsHelper.py:112-122): the
    weightless torchmetrics `ssim.*` and MSELoss `mse.*` entries of the
    reference's base AE are dropped (JAX `convert_recon_ae`,
    torch_convert.py:1487-1490), an EsViT trunk gets the checkpoint surgery
    of `load_encoder_checkpoint`, and the rest loads strictly. `-E` is
    ignored, with the JAX loader's message. Every `ae_*` family loads so: the
    DeiT, ViT, EsViT, NesT and EfficientFormer trunks under their family's
    name, the ResNet-50 and the vanilla CNN."""
    if encoder_ckpt:
        print("build_pth_models (recon): -E/--encoder-ckpt ignored — a recon .pth is the WHOLE "
              "AutoEncoder (its own frozen encoder included); the file's encoder weights are "
              "used")
    sd = {k: v for k, v in load_pth(pth_path).items() if not k.startswith(("ssim.", "mse."))}
    trunk = getattr(model, "trunk", None)
    if isinstance(trunk, SwinTransformer):
        pre = f"encoder.{model.family}."
        own = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
        sd = {**{k: v for k, v in sd.items() if not k.startswith(pre)},
              **{pre + k: v for k, v in _swin_checkpoint_surgery(trunk, own).items()}}
    model.load_state_dict(sd, strict=True)
    return model


def build_pth_resnet_mdn_models(
    pth_stages: Sequence[str],
    img_size: int = 224,
    encoder_ckpt: str = "",
    dtypes: Optional[DtypePolicy] = None,
    device: Optional[torch.device] = None,
) -> RunModels:
    """ResNet-50 encoder + the two stage MDN heads from the reference's
    two-file convention (JAX `build_pth_resnet_mdn_models` :370): one head
    `.pth` per stage, positionally stages 2 and 3 (D = 1024, 2048), K and the
    data class from the first filename. `encoder_ckpt` is the trunk the heads
    were trained against: the encoder file `cli.train_mdn -m res_net` writes
    (trained stage norms included) or ImageNet ResNet-50 weights; without it
    the trunk is the seed-random init (warned). The heads are built without
    an init of their own (on the meta device) and take the files' tensors."""
    stages = (2, 3)
    if len(pth_stages) != len(stages):
        raise ValueError(f"the ResNet-MDN convention is one .pth per stage {stages}, got "
                         f"{len(pth_stages)} files")
    num_gaussians, dataclass = parse_pth_filename(pth_stages[0], "mdn")
    hp = HyperParams(model_name="enc_res_net", architecture="mdn", img_size=img_size,
                     num_gaussians=num_gaussians or 150, data_class=dataclass)
    if dtypes is not None:
        hp.dtypes = dtypes
    encoder = ResNetEncoder(hp.img_size, hp.dtypes,
                            generator=torch.Generator().manual_seed(hp.seed))
    if encoder_ckpt:
        load_encoder_checkpoint(encoder, encoder_ckpt)
    else:
        print("build_pth_resnet_mdn_models: no encoder checkpoint given (-E) — evaluating "
              "against a random resnet50 trunk; the reference's GMM heads were trained on "
              "ImageNet-pretrained features")
    heads = []
    for i, pth in zip(stages, pth_stages):
        with torch.device("meta"):
            head = GaussianMDN(STAGE_CHANNELS[i], hp.num_gaussians, dtypes=hp.dtypes)
        head.load_state_dict(load_pth(pth), strict=True, assign=True)
        heads.append(head)
    heads = torch.nn.ModuleList(heads).requires_grad_(False)
    return RunModels(kind="mdn_resnet", hp=hp,
                     parts=(encoder.to(device).eval(), heads.to(device).eval()))


def score_models(m: RunModels, test_data, mean=None, std=None):
    """Label-free scoring dispatch: RunModels → pipeline.eval.ScoreOutput."""
    from vit_ad_tpu_torch.pipeline.eval import score_mdn, score_mdn_resnet, score_nf, score_recon

    score = {"nf": score_nf, "mdn": score_mdn, "mdn_resnet": score_mdn_resnet,
             "recon": score_recon}.get(m.kind)
    if score is None:
        raise NotImplementedError(f"scoring kind {m.kind!r} is not ported yet")
    return score(*m.parts, test_data, m.hp, mean, std)
