"""Head training loops (port of `vit_ad_tpu/pipeline/train.py`: `train_mdn`
:113, `train_nf` :286 and the joint step of `train_mdn_resnet` :805; the
NF-ResNet and recon trainers are ROADMAP A7b/A8).

`train_mdn` and `train_nf`: the trunk is frozen, its features are extracted
once and the head trains on them, cached on the device, with torch-semantics
Adam, early stopping on the validation loss and a final metric evaluation
(reference src/pipeline/LearnerMDN.py:97-240, LearnerNF.py:91-235).
`train_mdn_resnet` has no feature cache: the ResNet's stage LayerNorms train
with the two stage heads, so every step runs the frozen trunk on the images.
The JAX package's scan-of-batches epochs amortize TPU dispatch and are not
ported: an epoch is a Python loop over the staged batches.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vit_ad_tpu_torch.config import HyperParams, MeshConfig
from vit_ad_tpu_torch.data.dataset import default_norm_stats
from vit_ad_tpu_torch.data.loader import Batch, DataPipeline
from vit_ad_tpu_torch.models.flow import NormalizingFlow, patch_tokens_to_map
from vit_ad_tpu_torch.models.mdn import GaussianMDN
from vit_ad_tpu_torch.models.outputs import Encoder
from vit_ad_tpu_torch.models.resnet import STAGE_CHANNELS, ResNetEncoder
from vit_ad_tpu_torch.pipeline.early_stopping import run_epochs
from vit_ad_tpu_torch.pipeline.features import (
    extract_features,
    make_feature_extractor,
    stage_feature_batches,
)
from vit_ad_tpu_torch.pipeline.optimizers import torch_adam
from vit_ad_tpu_torch.registry import get_model

# loss(head, feats [B, P, D], valid [B], generator | None) → scalar
HeadLoss = Callable[[torch.nn.Module, torch.Tensor, torch.Tensor, Optional[torch.Generator]],
                    torch.Tensor]


@dataclasses.dataclass
class TrainResult:
    head: torch.nn.Module            # holds the best (lowest validation loss) weights
    encoder: torch.nn.Module
    history: Dict[str, Any]
    metrics: Dict[str, float]
    epochs_ran: int
    best_epoch: int
    best_valid_loss: float


def default_encoder(hp: HyperParams) -> Encoder:
    """The registry trunk with its seed-deterministic init (on the CPU)."""
    return get_model(hp.model_name, hp.img_size, hp.dtypes,
                     generator=torch.Generator().manual_seed(hp.seed), fused_ln=hp.fused_ln,
                     fused_mlp=hp.fused_mlp)


def _weighted_mean(losses: List[torch.Tensor], weights: List[float]) -> float:
    """Weighted mean of per-step loss scalars, fetched once per epoch."""
    if not losses:
        return float("nan")
    vals = torch.stack(losses).double().cpu().numpy()
    return float(np.average(vals, weights=weights))


def _masked_mean(per_example: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean over the valid rows of a padded batch."""
    return torch.sum(per_example * valid) / torch.clamp(torch.sum(valid), min=1.0)


def masked_mdn_loss(mdn: GaussianMDN, feats: torch.Tensor, valid: torch.Tensor,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """Mean NLL over the valid rows of a padded batch (JAX `masked_loss`
    :171-176); Gumbel noise from `generator` (None: the noiseless eval
    loss)."""
    return _masked_mean(-torch.mean(mdn.log_likelihood(feats, generator), dim=(1, 2)), valid)


def masked_nf_loss(flow: NormalizingFlow, feats: torch.Tensor, valid: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Mean over the valid rows of ½ Σ z² - logdet of the flow on the
    [B, √P, √P, D] map of the cached tokens (JAX `masked_loss` :341-345).
    The flow draws no noise; `generator` is the trainers' common argument."""
    z, logdet = flow.transform(patch_tokens_to_map(feats))
    return _masked_mean(0.5 * torch.sum(z * z, dim=(1, 2, 3)) - logdet, valid)


def train_step(loss_fn: HeadLoss, head: torch.nn.Module, opt: torch.optim.Optimizer,
               feats: torch.Tensor, valid: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """One optimizer step on one padded batch; returns the (detached) loss."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(head, feats, valid, generator)
    loss.backward()
    opt.step()
    return loss.detach()


def mdn_train_step(mdn: GaussianMDN, opt: torch.optim.Optimizer, feats: torch.Tensor,
                   valid: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    return train_step(masked_mdn_loss, mdn, opt, feats, valid, generator)


def _check_unported(hp: HyperParams) -> None:
    if hp.kmeans_init:
        raise NotImplementedError("k-means init of the MDN (pipeline/cluster_init.py) is not "
                                  "ported to vit_ad_tpu_torch yet (ROADMAP A5)")
    if hp.mesh != MeshConfig():
        raise NotImplementedError("--mesh training is not ported to vit_ad_tpu_torch yet "
                                  "(ROADMAP A11)")
    if not hp.cache_frozen_features:
        raise NotImplementedError("re-extracting features every epoch is not ported; the "
                                  "port always caches the frozen trunk's features")


def _train_head(hp: HyperParams, data: DataPipeline, test_data: Optional[DataPipeline],
                encoder: Optional[Encoder], device: Optional[str],
                log: Optional[Callable[[Dict[str, Any]], None]],
                make_head: Callable[[torch.Tensor], torch.nn.Module], loss_fn: HeadLoss,
                noisy: bool, evaluate: Callable[..., Dict[str, float]]) -> TrainResult:
    """The frozen-trunk trainer both heads share: cache the features, build
    the head from them (`make_head(feats_train)`, on the CPU), train with
    `loss_fn` (noise from one generator seeded with `hp.seed` when `noisy`;
    the validation loss is always noiseless), keep the best validation epoch,
    evaluate on `test_data`."""
    _check_unported(hp)
    if encoder is None:
        encoder = default_encoder(hp)
    if device is None:
        device = next(encoder.parameters()).device
    device = torch.device(device)
    encoder = encoder.to(device).eval()
    # --centering: the train set's statistics; else ImageNet's
    mean, std = data.compute_mean_std() if hp.centering else default_norm_stats()
    extractor = make_feature_extractor(encoder, hp.block_index, mean, std)
    feats_train = extract_features(extractor, data.train_batches(hp.prefetch), device)
    feats_valid = extract_features(extractor, data.valid_batches(hp.prefetch), device)

    head = make_head(feats_train).to(device)
    opt = torch_adam(head.parameters(), hp.learning_rate, hp.weight_decay)
    noise = torch.Generator(device=device).manual_seed(hp.seed) if noisy else None
    train_batches = stage_feature_batches(feats_train, hp.batch_size)
    valid_batches = stage_feature_batches(feats_valid, hp.batch_size)

    def train_epoch(epoch: int):
        losses, weights = [], []
        for feats, valid, w in train_batches():
            losses.append(train_step(loss_fn, head, opt, feats, valid, noise))
            weights.append(w)
        return _weighted_mean(losses, weights), float(sum(weights))

    def valid_epoch() -> float:
        losses, weights = [], []
        with torch.no_grad():
            for feats, valid, w in valid_batches():
                losses.append(loss_fn(head, feats, valid, None))
                weights.append(w)
        return _weighted_mean(losses, weights)

    history, epochs_ran, stopper = run_epochs(hp, train_epoch, valid_epoch, head.state_dict,
                                              log)
    if stopper.best_params is not None:
        head.load_state_dict(stopper.best_params)
    metrics: Dict[str, float] = {}
    if test_data is not None:
        metrics = evaluate(encoder, head, test_data, hp, mean, std)
    return TrainResult(
        head=head, encoder=encoder, history=history, metrics=metrics, epochs_ran=epochs_ran,
        best_epoch=stopper.best_epoch,
        best_valid_loss=float("nan") if stopper.best_loss is None else stopper.best_loss)


def train_mdn(hp: HyperParams, data: DataPipeline, test_data: Optional[DataPipeline] = None,
              encoder: Optional[Encoder] = None, device: Optional[str] = None,
              log: Optional[Callable[[Dict[str, Any]], None]] = None) -> TrainResult:
    """Train the GMM/MDN head on frozen-trunk features.

    `encoder` defaults to the registry trunk with its seeded init; it and
    the head live on `device` (default: the encoder's device, else the CPU).
    Each training step draws fresh Gumbel noise from one generator seeded
    with `hp.seed`; the validation loss is noiseless. The head ends with the
    weights of its best validation epoch, and is evaluated on `test_data`."""
    from vit_ad_tpu_torch.pipeline.eval import evaluate_mdn

    make = lambda feats: GaussianMDN(feats.shape[-1], hp.num_gaussians, dtypes=hp.dtypes,
                                     generator=torch.Generator().manual_seed(hp.seed))
    return _train_head(hp, data, test_data, encoder, device, log, make, masked_mdn_loss, True,
                       evaluate_mdn)


def train_nf(hp: HyperParams, data: DataPipeline, test_data: Optional[DataPipeline] = None,
             encoder: Optional[Encoder] = None, device: Optional[str] = None,
             log: Optional[Callable[[Dict[str, Any]], None]] = None) -> TrainResult:
    """Train the normalizing-flow head on frozen-trunk features (reference
    LearnerNF.train_with_transformer): one flow sized (D, √P x √P), Adam on
    the flow's parameters only, the NLL ½ Σ z² - logdet, early stopping (always
    active, as in the JAX package), best-epoch weights, final NF metrics.
    Arguments as `train_mdn`; the flow's init is seeded with `hp.seed`."""
    from vit_ad_tpu_torch.pipeline.eval import evaluate_nf

    make = lambda feats: NormalizingFlow(
        num_channels=feats.shape[-1], img_size=hp.img_size, num_patches=feats.shape[1],
        hidden_ratio=hp.hidden_ratio, flow_steps=hp.flow_steps,
        generator=torch.Generator().manual_seed(hp.seed))
    return _train_head(hp, data, test_data, encoder, device, log, make, masked_nf_loss, False,
                       evaluate_nf)


RESNET_MDN_STAGES = (2, 3)  # reference LearnerMDN.py:268-279: stage maps 2 and 3


def mdn_resnet_loss(encoder: ResNetEncoder, heads: Sequence[GaussianMDN],
                    images_u8: torch.Tensor, valid: torch.Tensor,
                    generator: Optional[torch.Generator], mean: Optional[torch.Tensor],
                    std: Optional[torch.Tensor],
                    stages: Sequence[int] = RESNET_MDN_STAGES) -> torch.Tensor:
    """The joint objective (JAX `loss_fn` :889): the masked mean NLL of every
    stage head on its LayerNorm'd stage map, summed. The trunk runs without
    gradient; the stage norms and the heads differentiate, so on the card the
    GMM feature-gradient kernel (B4) runs in the backward."""
    from vit_ad_tpu_torch.pipeline.eval import resnet_stage_tokens

    tokens = resnet_stage_tokens(encoder, images_u8, mean, std, stages)
    return sum(masked_mdn_loss(mdn, feats, valid, generator)
               for feats, mdn in zip(tokens, heads))


def mdn_resnet_train_step(encoder: ResNetEncoder, heads: Sequence[GaussianMDN],
                          opt: torch.optim.Optimizer, images_u8: torch.Tensor,
                          valid: torch.Tensor, generator: Optional[torch.Generator],
                          mean: Optional[torch.Tensor], std: Optional[torch.Tensor],
                          stages: Sequence[int] = RESNET_MDN_STAGES) -> torch.Tensor:
    """One joint optimizer step on one padded uint8 batch; returns the
    (detached) loss."""
    opt.zero_grad(set_to_none=True)
    loss = mdn_resnet_loss(encoder, heads, images_u8, valid, generator, mean, std, stages)
    loss.backward()
    opt.step()
    return loss.detach()


def stage_image_batches(batches: Iterable[Batch], device: torch.device
                        ) -> List[Tuple[torch.Tensor, torch.Tensor, float]]:
    """The padded uint8 batches of a split, decoded once and kept on `device`:
    (images [B, H, W, 3] uint8, valid [B] f32, valid count)."""
    return [(torch.from_numpy(b.images).to(device),
             torch.from_numpy(b.valid).to(device=device, dtype=torch.float32),
             float(b.valid.sum())) for b in batches]


def train_mdn_resnet(hp: HyperParams, data: DataPipeline,
                     test_data: Optional[DataPipeline] = None,
                     encoder: Optional[ResNetEncoder] = None, device: Optional[str] = None,
                     log: Optional[Callable[[Dict[str, Any]], None]] = None) -> TrainResult:
    """MDN over ResNet stages 2 and 3: two GMM heads (D=1024 and D=2048 on a
    ResNet-50), one per stage map, summed NLL, one Adam over the heads and the
    encoder's stage LayerNorms (reference LearnerMDN.learn_mdn_resnet; JAX
    `train_mdn_resnet` :805, its joint step).

    The trunk is frozen and stays in eval mode. The heads are made on
    `device` (at K=100 their weights are 4.2 GB of f32). Each training step
    draws fresh Gumbel noise from one generator seeded with `hp.seed`; the
    validation loss is noiseless. The uint8 batches are decoded once and kept
    on the device. Heads and stage norms end with the weights of the best
    validation epoch; `TrainResult.head` is the `nn.ModuleList` of the stage
    heads and `.encoder` the encoder with its trained norms. Stage norms 0 and
    1 feed no head and keep their init, as in the reference (torch Adam skips
    parameters without a gradient).

    Not ported: the K-chunked update of `pipeline/mdn_chunked.py` (a
    workaround for a smaller device memory; PERF.md has what the joint step
    takes on the H100), `--mesh`."""
    from vit_ad_tpu_torch.pipeline.eval import evaluate_mdn_resnet

    _check_unported(hp)
    stages = RESNET_MDN_STAGES
    if encoder is None:
        encoder = ResNetEncoder(hp.img_size, hp.dtypes,
                                generator=torch.Generator().manual_seed(hp.seed))
    if device is None:
        device = next(encoder.parameters()).device
    device = torch.device(device)
    encoder = encoder.to(device).eval()
    mean, std = data.compute_mean_std() if hp.centering else default_norm_stats()
    mean_t, std_t = (torch.as_tensor(a, dtype=torch.float32, device=device)
                     for a in (mean, std))

    with torch.device(device):
        init = torch.Generator(device=device).manual_seed(hp.seed)
        heads = torch.nn.ModuleList(
            GaussianMDN(STAGE_CHANNELS[i], hp.num_gaussians, dtypes=hp.dtypes, generator=init)
            for i in stages)
    # what trains: the heads and the stage norms (the trunk and its BatchNorm
    # statistics never change; `encoder.state_dict()` carries them to a file)
    trainable = torch.nn.ModuleDict({"heads": heads, "norms": encoder.norms})
    opt = torch_adam(trainable.parameters(), hp.learning_rate, hp.weight_decay)
    noise = torch.Generator(device=device).manual_seed(hp.seed)
    train_batches = stage_image_batches(data.train_batches(hp.prefetch), device)
    valid_batches = stage_image_batches(data.valid_batches(hp.prefetch), device)

    def train_epoch(epoch: int):
        losses, weights = [], []
        for images, valid, w in train_batches:
            losses.append(mdn_resnet_train_step(encoder, heads, opt, images, valid, noise,
                                                mean_t, std_t, stages))
            weights.append(w)
        return _weighted_mean(losses, weights), float(sum(weights))

    def valid_epoch() -> float:
        losses, weights = [], []
        with torch.no_grad():
            for images, valid, w in valid_batches:
                losses.append(mdn_resnet_loss(encoder, heads, images, valid, None, mean_t,
                                              std_t, stages))
                weights.append(w)
        return _weighted_mean(losses, weights)

    history, epochs_ran, stopper = run_epochs(hp, train_epoch, valid_epoch,
                                              trainable.state_dict, log)
    if stopper.best_params is not None:
        trainable.load_state_dict(stopper.best_params)
    metrics: Dict[str, float] = {}
    if test_data is not None:
        metrics = evaluate_mdn_resnet(encoder, heads, test_data, hp, mean, std, stages)
    return TrainResult(
        head=heads, encoder=encoder, history=history, metrics=metrics, epochs_ran=epochs_ran,
        best_epoch=stopper.best_epoch,
        best_valid_loss=float("nan") if stopper.best_loss is None else stopper.best_loss)
