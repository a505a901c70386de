"""Rebuild a trained run's live models (port of `vit_ad_tpu/pipeline/loading.py`).

Two sources, as in the JAX package:

  * a run directory (`load_run`, :27-211): its `config.json` (the trainer's
    `HyperParams.to_log_dict()` plus `checkpoints`, the names of its weight
    files in load order) and those files. The encoder is rebuilt with the
    seed-deterministic init the trainer started from; the files hold the
    trained head (the whole auto-encoder of a recon run; the stage heads and
    the encoder with its trained stage norms of a ResNet run). A JAX run
    directory (orbax `best_params`, `best_params.msgpack`) is refused with
    the way across: the JAX package's `cli.export_weights`, then `--pth`;
  * reference-format `.pth` files (`build_pth_models`,
    `build_pth_resnet_mdn_models`).

`score_models` and `evaluate_models` dispatch a `RunModels` to the matching
`pipeline.eval` function; `compress_params_bf16` rounds its weights to bf16
values (`cli.score --weights-dtype bf16`). Every `.pth` is read with
`torch.load(weights_only=True)`: tensors only, no pickled code.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import pickle
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

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


RUN_CONFIG = "config.json"
# what the JAX trainers' `save_params` leaves in a run directory
JAX_CHECKPOINTS = ("best_params", "best_params.msgpack")
# the file `cli.convert_weights` writes into its destination directory
CONVERTED_ENCODER = "encoder.pth"


@dataclass
class RunModels:
    """Live models for one head. `parts` is the positional model prefix the
    matching `pipeline.eval.score_*` / `evaluate_*` function takes."""

    kind: str  # 'nf' | 'mdn' | 'recon' | 'mdn_resnet' | 'nf_resnet'
    hp: HyperParams
    parts: Tuple[Any, ...]


def hp_from_config(cfg: Dict[str, Any]) -> HyperParams:
    """HyperParams from a run's config.json (JAX `hp_from_config` :27):
    unknown keys are ignored; the dtype policy and the mesh are not recorded,
    so a restored run scores on one device under the default policy."""
    hp = HyperParams()
    for k, v in cfg.items():
        if hasattr(hp, k):
            setattr(hp, k, v)
    return hp


def load_run_config(run_dir: str) -> Tuple[HyperParams, Dict[str, Any]]:
    with open(os.path.join(run_dir, RUN_CONFIG)) as f:
        cfg = json.load(f)
    return hp_from_config(cfg), cfg


def find_checkpoint(run_dir: str, cfg: Optional[Dict[str, Any]] = None) -> List[str]:
    """The paths of the weight files the run's `config.json` lists under
    `checkpoints`, in load order (no glob: a leftover temporary file of an
    interrupted save is never read). A JAX run directory exits naming the
    way across."""
    if cfg is None:
        cfg = load_run_config(run_dir)[1]
    names = cfg.get("checkpoints")
    if not names:
        jax_files = sorted(n for n in os.listdir(run_dir) if n in JAX_CHECKPOINTS)
        if jax_files:
            raise SystemExit(
                f"{run_dir}: a run directory of the JAX package ({', '.join(jax_files)}: "
                "orbax/msgpack params, which need jax). Carry its weights across with "
                f"`python -m vit_ad_tpu.cli.export_weights --run {run_dir} --dst <dir>`, then "
                "score the exported .pth files with --pth")
        raise FileNotFoundError(f"no checkpoint in {run_dir}: its {RUN_CONFIG} lists none "
                                "under 'checkpoints'")
    paths = [os.path.join(run_dir, n) for n in names]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(f"{run_dir}: checkpoint files listed in {RUN_CONFIG} are "
                                f"missing: {missing}")
    return paths


def build_run_models(hp: HyperParams, ckpts: Sequence[str],
                     device: Optional[torch.device] = None) -> RunModels:
    """The run's models (JAX `build_run_models` :153) on `device` (default
    CPU), in eval mode: the registry encoder with the trainer's seeded init
    and the head of `ckpts[0]` (NF, MDN), or the whole auto-encoder
    (reconstruction); for a ResNet run the stage heads of `ckpts[:-1]` and
    the encoder of `ckpts[-1]`, its trained stage norms and BatchNorm
    statistics included. Every file loads strictly."""
    from vit_ad_tpu_torch.pipeline.train import NF_RESNET_STAGES, default_encoder, stage_flow

    arch = hp.architecture
    if hp.model_name == "enc_res_net" and arch == "mdn":
        m = build_pth_resnet_mdn_models(ckpts[:-1], img_size=hp.img_size,
                                        encoder_ckpt=ckpts[-1], dtypes=hp.dtypes, device=device)
        return dataclasses.replace(m, hp=hp)
    if hp.model_name == "enc_res_net" and arch == "nf":
        if len(ckpts) != len(NF_RESNET_STAGES) + 1:
            raise ValueError(f"an NF-ResNet run has one flow file per stage "
                             f"{NF_RESNET_STAGES} and the encoder file; got {ckpts}")
        encoder = default_encoder(hp)
        load_encoder_checkpoint(encoder, ckpts[-1])
        flows = torch.nn.ModuleList(stage_flow(hp, i) for i in NF_RESNET_STAGES)
        for flow, path in zip(flows, ckpts):
            flow.load_state_dict(load_pth(path), strict=True)
        return RunModels(kind="nf_resnet", hp=hp,
                         parts=(encoder.to(device).eval(), flows.to(device).eval()))
    model = default_encoder(hp)
    if arch == "reconstruction":
        return RunModels(kind="recon", hp=hp,
                         parts=(_load_recon_model(model, ckpts[0], "").to(device).eval(),))
    return RunModels(kind=arch, hp=hp,
                     parts=(model.to(device).eval(),
                            _load_head(model, arch, hp, ckpts[0]).to(device).eval()))


def load_run(run_dir: str, device: Optional[torch.device] = None
             ) -> Tuple[RunModels, Dict[str, Any]]:
    """One-call form: run directory → (RunModels, raw config dict)."""
    hp, cfg = load_run_config(run_dir)
    return build_run_models(hp, find_checkpoint(run_dir, cfg), device), cfg


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
    """A `.pth` state dict on the CPU, unwrapped from its container as the
    JAX `torch_convert.load_pth` (:74) unwraps it: the first of 'student'
    (the EsViT release format {'student': ..., 'teacher': ..., 'epoch': ...},
    reference TransformerEncoder.py:248), 'state_dict' and 'model' that holds
    a dict. Tensors only: a file that also pickles another type (a DINO
    `args` namespace) is refused with the file and the type named."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        found = re.search(r"GLOBAL (\S+)", str(e))
        raise ValueError(
            f"{path}: holds a pickled {found.group(1) if found else 'object'}, which a "
            "tensors-only load refuses; save its state dict alone (for example "
            "torch.save(ckpt['student'], ...)) and pass that file") from None
    for key in ("student", "state_dict", "model"):
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
    the Swin file also gets `_swin_checkpoint_surgery`. A directory that
    `cli.convert_weights` wrote stands for its `encoder.pth`."""
    converted = os.path.join(encoder_ckpt, CONVERTED_ENCODER)
    if os.path.isdir(encoder_ckpt) and os.path.isfile(converted):
        encoder_ckpt = converted
    if not encoder_ckpt.endswith(".pth"):
        raise SystemExit(
            f"encoder checkpoint {encoder_ckpt!r}: the port reads .pth files; an orbax "
            "checkpoint directory of the JAX package needs jax: convert it with "
            "`python -m vit_ad_tpu.cli.export_weights --run <run dir> --dst <dir>` first")
    return load_encoder_state(encoder, load_pth(encoder_ckpt))


def load_encoder_state(encoder: Encoder, sd: Dict[str, torch.Tensor]) -> Encoder:
    """The surgery of `load_encoder_checkpoint` on an unwrapped state dict,
    then a strict load into `encoder`; returns it."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
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
    return RunModels(kind=arch, hp=hp,
                     parts=(encoder.to(device).eval(),
                            _load_head(encoder, arch, hp, pth_path).to(device).eval()))


def _load_head(encoder: Encoder, arch: str, hp: HyperParams, pth_path: str) -> torch.nn.Module:
    """The MDN or NF head of `pth_path`, sized for `encoder`'s tokens."""
    if arch == "mdn":
        head = GaussianMDN(encoder.embed_dim, hp.num_gaussians, dtypes=hp.dtypes)
        head.load_state_dict(load_pth(pth_path), strict=True)
        return head
    head = NormalizingFlow(num_channels=encoder.embed_dim, img_size=hp.img_size,
                           num_patches=encoder.num_patches, hidden_ratio=hp.hidden_ratio,
                           flow_steps=hp.flow_steps)
    head.fast_flow_decoder.load_state_dict(_flow_decoder_state(load_pth(pth_path)), strict=True)
    return head


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


def _dispatch(m: RunModels, score: bool):
    from vit_ad_tpu_torch.pipeline import eval as E

    table = {"nf": (E.score_nf, E.evaluate_nf), "mdn": (E.score_mdn, E.evaluate_mdn),
             "recon": (E.score_recon, E.evaluate_recon),
             "mdn_resnet": (E.score_mdn_resnet, E.evaluate_mdn_resnet),
             "nf_resnet": (E.score_nf_resnet, E.evaluate_nf_resnet)}
    return table[m.kind][0 if score else 1]


def score_models(m: RunModels, test_data, mean=None, std=None, keep_origs: int = 0):
    """Label-free scoring dispatch: RunModels → pipeline.eval.ScoreOutput."""
    return _dispatch(m, True)(*m.parts, test_data, m.hp, mean, std, keep_origs=keep_origs)


def evaluate_models(m: RunModels, test_data, mean=None, std=None,
                    figures_dir: Optional[str] = None, logger: Any = None) -> Dict[str, float]:
    """Labelled re-evaluation dispatch: RunModels → the reference metric dict
    (+ figures)."""
    return _dispatch(m, False)(*m.parts, test_data, m.hp, mean, std, figures_dir=figures_dir,
                               logger=logger)


def compress_params_bf16(m: RunModels) -> int:
    """bf16-at-rest weights for serving (JAX `compress_params_bf16` :437; an
    opt-in that the JAX package measured slower and drifting on its one-shot
    wave). Rounds every f32 parameter and buffer of the run's models in place
    to its bf16 value: the heads, the trunk, the stage norms and the
    BatchNorm statistics; the tensors keep their dtype, so each layer computes
    as before on the rounded values, as the JAX modules promote bf16 params to
    their compute dtype. The in-place writes move each tensor's version, so
    the trunks' cached compute-dtype weights and folded BatchNorms
    (`layers.ComputeWeights`) are made again from the rounded values. Returns
    the number of tensors cast; raises when there was none (the JAX function
    skips a part it does not recognise without a word)."""
    seen = set()
    with torch.no_grad():
        for part in m.parts:
            for t in itertools.chain(part.parameters(), part.buffers()):
                if t.dtype == torch.float32 and id(t) not in seen:
                    seen.add(id(t))
                    t.copy_(t.to(torch.bfloat16))
    if not seen:
        raise ValueError(f"compress_params_bf16: no f32 parameter or buffer in the {m.kind!r} "
                         "models; nothing was cast")
    return len(seen)
