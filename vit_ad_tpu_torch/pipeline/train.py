"""Head training loops (port of `vit_ad_tpu/pipeline/train.py`: `train_mdn`
:113, `train_nf` :286, `train_recon` :461, the joint step of
`train_mdn_resnet` :805, `train_nf_resnet` :1264 and `train_vae` :1454).

`train_mdn` and `train_nf`: the trunk is frozen, its features are extracted
once and the head trains on them, cached on the device, with torch-semantics
Adam, early stopping on the validation loss and a final metric evaluation
(reference src/pipeline/LearnerMDN.py:97-240, LearnerNF.py:91-235).
`train_mdn_resnet` and `train_nf_resnet` have no feature cache: the ResNet's
stage LayerNorms train with the stage heads (two GMMs on stage maps 2 and 3,
or three flows on stage maps 0-2), so every step runs the frozen trunk on the
images.
`train_recon` trains an auto-encoder's decoder (the vanilla AE: all of it);
a transformer AE's frozen trunk runs once over the batches (the latent cache)
and each step runs the decoder alone. `train_vae` trains the variational
auto-encoder end to end (no kernel of the repo on its path).
The JAX package's scan-of-batches epochs amortize TPU dispatch and are not
ported: an epoch is a Python loop over the staged batches. Every trainer
takes `log` (called with each epoch's row and, after the final evaluation,
the metrics with `"stage": "eval"`, as the JAX trainers log them),
`figures_dir` (the evaluator's figures) and `logger` (a
`utils.logging.MetricLogger` the figures are registered with).

With `hp.mesh` (`--mesh DxM`, JAX `_mesh_setup` :103) every trainer runs as one
rank of a (data, model) mesh (`parallel/context.MeshContext`): each data rank
takes its rows of every padded batch, the loss is the global masked mean
(each rank backpropagates its rows' sum over the global valid count and the
gradients are summed over the data axis), noise is the single-device draw
(each rank draws the global shape and keeps its rows), the MDN heads hold
K/M mixture components a model rank, the frozen transformer trunks of
`train_mdn`, `train_nf` and a transformer AE's `train_recon` are sharded
over the model axis when it is above one (JAX :137-146, :312-320, :496-502;
every rank of a model group calls the trunk on the same rows, together),
BatchNorms in training take global-batch statistics, and everything else is
replicated. The validation
loss is the global one, so every rank takes the same early-stopping
decisions; the best weights are kept per rank, as shards.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vit_ad_tpu_torch.config import HyperParams
from vit_ad_tpu_torch.data.dataset import default_norm_stats
from vit_ad_tpu_torch.data.loader import Batch, DataPipeline, preprocess
from vit_ad_tpu_torch.models.autoencoder import TransformerAutoEncoder, VanillaAutoEncoder
from vit_ad_tpu_torch.models.flow import NormalizingFlow, patch_tokens_to_map
from vit_ad_tpu_torch.models.mdn import GaussianMDN
from vit_ad_tpu_torch.models.outputs import Encoder
from vit_ad_tpu_torch.models.resnet import STAGE_CHANNELS, STAGE_SCALES, ResNetEncoder
from vit_ad_tpu_torch.models.vae import VariationalAutoEncoder, kl_per_example
from vit_ad_tpu_torch.ops.ssim import ssim_per_image
from vit_ad_tpu_torch.parallel.context import MeshContext
from vit_ad_tpu_torch.pipeline.early_stopping import run_epochs
from vit_ad_tpu_torch.pipeline.features import (
    extract_features,
    gather_features,
    make_feature_extractor,
    shard_feature_batches,
    stage_feature_batches,
)
from vit_ad_tpu_torch.pipeline.optimizers import torch_adam
from vit_ad_tpu_torch.registry import get_model
from vit_ad_tpu_torch.utils.profiling import span

# loss(head, feats [B, P, D], valid [B], generator | None, mc=mesh | None) → scalar
HeadLoss = Callable[[torch.nn.Module, torch.Tensor, torch.Tensor, Optional[torch.Generator]],
                    torch.Tensor]
Log = Optional[Callable[[Dict[str, Any]], None]]
# the number of each `optimizer_step` in the process, the args of its span:
# a label in a trace, read by nothing in the program
_steps = itertools.count()


@dataclasses.dataclass
class TrainResult:
    head: torch.nn.Module            # holds the best (lowest validation loss) weights
    encoder: Optional[torch.nn.Module]  # None for train_recon: `head` is the whole AE
    history: Dict[str, Any]
    metrics: Dict[str, float]
    epochs_ran: int
    best_epoch: int
    best_valid_loss: float


def default_encoder(hp: HyperParams) -> torch.nn.Module:
    """The registry model of `hp.model_name` with its seed-deterministic init
    (on the CPU): a trunk, or for the ae_* keys the whole auto-encoder."""
    return get_model(hp.model_name, hp.img_size, hp.dtypes,
                     generator=torch.Generator().manual_seed(hp.seed), fused_ln=hp.fused_ln,
                     fused_mlp=hp.fused_mlp)


def _weighted_mean(losses: List[torch.Tensor], weights: List[float],
                   mc: Optional[MeshContext] = None) -> float:
    """Weighted mean of per-step loss scalars, fetched once per epoch; on a
    mesh each scalar is a data rank's part of the step's loss, summed over the
    data axis first."""
    if not losses:
        return float("nan")
    vals = torch.stack(losses)
    if mc is not None:
        vals = mc.data_sum(vals)
    return float(np.average(vals.double().cpu().numpy(), weights=weights))


def _masked_mean(per_example: torch.Tensor, valid: torch.Tensor,
                 mc: Optional[MeshContext] = None) -> torch.Tensor:
    """Mean over the valid rows of a padded batch; on a mesh, this data
    rank's part of the global mean: its rows' sum over the global count."""
    count = torch.sum(valid)
    if mc is not None:
        count = mc.data_sum(count)
    return torch.sum(per_example * valid) / torch.clamp(count, min=1.0)


def masked_mdn_loss(mdn: GaussianMDN, feats: torch.Tensor, valid: torch.Tensor,
                    generator: Optional[torch.Generator],
                    mc: Optional[MeshContext] = None) -> torch.Tensor:
    """Mean NLL over the valid rows of a padded batch (JAX `masked_loss`
    :171-176); Gumbel noise from `generator` (None: the noiseless eval
    loss)."""
    return _masked_mean(-torch.mean(mdn.log_likelihood(feats, generator), dim=(1, 2)), valid,
                        mc)


def masked_nf_loss(flow: NormalizingFlow, feats: torch.Tensor, valid: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   mc: Optional[MeshContext] = None) -> torch.Tensor:
    """Mean over the valid rows of ½ Σ z² - logdet of the flow on the
    [B, √P, √P, D] map of the cached tokens (JAX `masked_loss` :341-345).
    The flow draws no noise; `generator` is the trainers' common argument."""
    z, logdet = flow.transform(patch_tokens_to_map(feats))
    return _masked_mean(0.5 * torch.sum(z * z, dim=(1, 2, 3)) - logdet, valid, mc)


def optimizer_step(opt: torch.optim.Optimizer, loss: Callable[[], torch.Tensor],
                   mc: Optional[MeshContext] = None) -> torch.Tensor:
    """Zero the gradients, backpropagate `loss()`, on a mesh sum the
    gradients over the data axis, step; returns the (detached) loss. The
    step is the span `train_step`, numbered in the process's order."""
    with span("train_step", {"step": next(_steps)}):
        with span("zero_grad"):
            opt.zero_grad(set_to_none=True)
        with span("loss"):
            out = loss()
        with span("backward"):
            out.backward()
        if mc is not None:
            with span("grad_sum"):
                mc.sum_gradients(p for group in opt.param_groups for p in group["params"])
        with span("optimizer"):
            opt.step()
        return out.detach()


def train_step(loss_fn: HeadLoss, head: torch.nn.Module, opt: torch.optim.Optimizer,
               feats: torch.Tensor, valid: torch.Tensor,
               generator: Optional[torch.Generator],
               mc: Optional[MeshContext] = None) -> torch.Tensor:
    """One optimizer step on one padded batch; returns the (detached) loss
    (on a mesh, this data rank's part of it)."""
    return optimizer_step(opt, lambda: loss_fn(head, feats, valid, generator, mc=mc), mc)


def mdn_train_step(mdn: GaussianMDN, opt: torch.optim.Optimizer, feats: torch.Tensor,
                   valid: torch.Tensor, generator: Optional[torch.Generator],
                   mc: Optional[MeshContext] = None) -> torch.Tensor:
    return train_step(masked_mdn_loss, mdn, opt, feats, valid, generator, mc)


def _evaluated(evaluate: Callable[..., Dict[str, float]], test_data: Optional[DataPipeline],
               log: Log, *args, **kwargs) -> Dict[str, float]:
    """The final metrics on `test_data` ({} without), logged as the eval
    row."""
    if test_data is None:
        return {}
    metrics = evaluate(*args, test_data, **kwargs)
    if log is not None:
        log({**metrics, "stage": "eval"})
    return metrics


def _result(head: torch.nn.Module, encoder: Optional[torch.nn.Module], history, metrics,
            epochs_ran: int, stopper) -> TrainResult:
    return TrainResult(
        head=head, encoder=encoder, history=history, metrics=metrics, epochs_ran=epochs_ran,
        best_epoch=stopper.best_epoch,
        best_valid_loss=float("nan") if stopper.best_loss is None else stopper.best_loss)


def _check_unported(hp: HyperParams) -> None:
    if not hp.cache_frozen_features:
        raise NotImplementedError("re-extracting features every epoch is not ported; the "
                                  "port always caches the frozen trunk's features")


def _mesh_setup(hp: HyperParams, device: torch.device) -> Optional[MeshContext]:
    """The trainers' mesh (JAX `_mesh_setup` :103): None without `hp.mesh`,
    else the validated MeshContext of this rank on `device`."""
    mc = MeshContext.from_hp(hp, devices=device)
    if mc is not None:
        mc.check_batch(hp.batch_size)
    return mc


def _train_head(hp: HyperParams, data: DataPipeline, test_data: Optional[DataPipeline],
                encoder: Optional[Encoder], device: Optional[str], log: Log,
                make_head: Callable[[torch.Size], torch.nn.Module], loss_fn: HeadLoss,
                noisy: bool, evaluate: Callable[..., Dict[str, float]],
                figures_dir: Optional[str], logger: Any,
                seed_head: Optional[Callable[[torch.nn.Module, torch.Tensor], None]] = None,
                ) -> TrainResult:
    """The frozen-trunk trainer both heads share: cache the features, build
    the head for their [B, P, D] shape (`make_head`, on the CPU), let
    `seed_head(head, feats_train)` set it from the training features if
    given, train with `loss_fn` (noise from one generator seeded with
    `hp.seed` when `noisy`; the validation loss is always noiseless), keep the
    best validation epoch, evaluate on `test_data`. On a mesh each data rank
    extracts and caches the features of its own rows of every batch; only
    `seed_head` needs every rank's, so only then are they gathered, and the
    primary alone seeds the head and broadcasts it before it is placed on the
    mesh."""
    _check_unported(hp)
    if encoder is None:
        encoder = default_encoder(hp)
    if device is None:
        device = next(encoder.parameters()).device
    device = torch.device(device)
    mc = _mesh_setup(hp, device)
    encoder = encoder.to(device).eval()
    if mc is not None:
        encoder = mc.shard_params(encoder)
    # --centering: the train set's statistics; else ImageNet's
    mean, std = data.compute_mean_std() if hp.centering else default_norm_stats()
    extractor = make_feature_extractor(encoder, hp.block_index, mean, std)
    if mc is None:
        feats_train = extract_features(extractor, data.train_batches(hp.prefetch), device)
        feats_valid = extract_features(extractor, data.valid_batches(hp.prefetch), device)
        train_batches = stage_feature_batches(feats_train, hp.batch_size)
        valid_batches = stage_feature_batches(feats_valid, hp.batch_size)
        head = make_head(feats_train.shape)
        if seed_head is not None:
            seed_head(head, feats_train)
        del feats_train
    else:
        train_batches = shard_feature_batches(extractor, data.train_batches(hp.prefetch),
                                              device, mc)
        valid_batches = shard_feature_batches(extractor, data.valid_batches(hp.prefetch),
                                              device, mc)
        head = make_head(next(train_batches())[0].shape)
        if seed_head is not None:
            feats_train = gather_features(train_batches, mc)
            if mc.mesh.rank == 0:
                seed_head(head, feats_train)
            del feats_train
            mc.replicate(head)

    head = head.to(device)
    if mc is not None:
        head = mc.shard_params(head)
    opt = torch_adam(head.parameters(), hp.learning_rate, hp.weight_decay)
    noise = torch.Generator(device=device).manual_seed(hp.seed) if noisy else None

    def train_epoch(epoch: int):
        losses, weights = [], []
        for feats, valid, w in train_batches():
            losses.append(train_step(loss_fn, head, opt, feats, valid, noise, mc))
            weights.append(w)
        return _weighted_mean(losses, weights, mc), float(sum(weights))

    def valid_epoch() -> float:
        losses, weights = [], []
        with torch.no_grad():
            for feats, valid, w in valid_batches():
                losses.append(loss_fn(head, feats, valid, None, mc=mc))
                weights.append(w)
        return _weighted_mean(losses, weights, mc)

    history, epochs_ran, stopper = run_epochs(hp, train_epoch, valid_epoch, head.state_dict,
                                              log)
    if stopper.best_params is not None:
        head.load_state_dict(stopper.best_params)
    metrics = _evaluated(evaluate, test_data, log, encoder, head, hp=hp, mean=mean, std=std,
                         figures_dir=figures_dir, logger=logger)
    return _result(head, encoder, history, metrics, epochs_ran, stopper)


def train_mdn(hp: HyperParams, data: DataPipeline, test_data: Optional[DataPipeline] = None,
              encoder: Optional[Encoder] = None, device: Optional[str] = None, log: Log = None,
              figures_dir: Optional[str] = None, logger: Any = None) -> TrainResult:
    """Train the GMM/MDN head on frozen-trunk features.

    `encoder` defaults to the registry trunk with its seeded init; it and
    the head live on `device` (default: the encoder's device, else the CPU).
    With `hp.kmeans_init` the head's mu bias starts at the k-means centres
    of the cached training features (`pipeline/cluster_init.py`, on the
    host), before the optimizer is built (JAX :153-165).
    Each training step draws fresh Gumbel noise from one generator seeded
    with `hp.seed`; the validation loss is noiseless. The head ends with the
    weights of its best validation epoch, and is evaluated on `test_data`."""
    from vit_ad_tpu_torch.pipeline.cluster_init import kmeans_cluster_centers, seed_mdn_mu_bias
    from vit_ad_tpu_torch.pipeline.eval import evaluate_mdn

    make = lambda shape: GaussianMDN(shape[-1], hp.num_gaussians, dtypes=hp.dtypes,
                                     generator=torch.Generator().manual_seed(hp.seed))

    def seed(mdn: GaussianMDN, feats: torch.Tensor) -> None:
        seed_mdn_mu_bias(mdn, kmeans_cluster_centers(feats.float().cpu().numpy(),
                                                     hp.num_gaussians))

    return _train_head(hp, data, test_data, encoder, device, log, make, masked_mdn_loss, True,
                       evaluate_mdn, figures_dir, logger,
                       seed_head=seed if hp.kmeans_init else None)


def train_nf(hp: HyperParams, data: DataPipeline, test_data: Optional[DataPipeline] = None,
             encoder: Optional[Encoder] = None, device: Optional[str] = None, log: Log = None,
             figures_dir: Optional[str] = None, logger: Any = None) -> TrainResult:
    """Train the normalizing-flow head on frozen-trunk features (reference
    LearnerNF.train_with_transformer): one flow sized (D, √P x √P), Adam on
    the flow's parameters only, the NLL ½ Σ z² - logdet, early stopping (always
    active, as in the JAX package), best-epoch weights, final NF metrics.
    Arguments as `train_mdn`; the flow's init is seeded with `hp.seed`."""
    from vit_ad_tpu_torch.pipeline.eval import evaluate_nf

    make = lambda shape: NormalizingFlow(
        num_channels=shape[-1], img_size=hp.img_size, num_patches=shape[1],
        hidden_ratio=hp.hidden_ratio, flow_steps=hp.flow_steps,
        generator=torch.Generator().manual_seed(hp.seed))
    return _train_head(hp, data, test_data, encoder, device, log, make, masked_nf_loss, False,
                       evaluate_nf, figures_dir, logger)


RESNET_MDN_STAGES = (2, 3)  # reference LearnerMDN.py:268-279: stage maps 2 and 3


def mdn_resnet_loss(encoder: ResNetEncoder, heads: Sequence[GaussianMDN],
                    images_u8: torch.Tensor, valid: torch.Tensor,
                    generator: Optional[torch.Generator], mean: Optional[torch.Tensor],
                    std: Optional[torch.Tensor],
                    stages: Sequence[int] = RESNET_MDN_STAGES,
                    mc: Optional[MeshContext] = None) -> torch.Tensor:
    """The joint objective (JAX `loss_fn` :889): the masked mean NLL of every
    stage head on its LayerNorm'd stage map, summed. The trunk runs without
    gradient; the stage norms and the heads differentiate, so on the card the
    GMM feature-gradient kernel (B4) runs in the backward."""
    from vit_ad_tpu_torch.pipeline.eval import resnet_stage_tokens

    tokens = resnet_stage_tokens(encoder, images_u8, mean, std, stages)
    return sum(masked_mdn_loss(mdn, feats, valid, generator, mc)
               for feats, mdn in zip(tokens, heads))


def mdn_resnet_train_step(encoder: ResNetEncoder, heads: Sequence[GaussianMDN],
                          opt: torch.optim.Optimizer, images_u8: torch.Tensor,
                          valid: torch.Tensor, generator: Optional[torch.Generator],
                          mean: Optional[torch.Tensor], std: Optional[torch.Tensor],
                          stages: Sequence[int] = RESNET_MDN_STAGES,
                          mc: Optional[MeshContext] = None) -> torch.Tensor:
    """One joint optimizer step on one padded uint8 batch; returns the
    (detached) loss."""
    return optimizer_step(opt, lambda: mdn_resnet_loss(encoder, heads, images_u8, valid,
                                                       generator, mean, std, stages, mc), mc)


def stage_image_batches(batches: Iterable[Batch], device: torch.device,
                        mc: Optional[MeshContext] = None
                        ) -> List[Tuple[torch.Tensor, torch.Tensor, float]]:
    """The padded uint8 batches of a split, decoded once and kept on `device`:
    (images [B, H, W, 3] uint8, valid [B] f32, valid count); on a mesh, this
    data rank's rows of each and the global count."""
    staged = []
    for b in batches:
        images, valid = (b.images, b.valid) if mc is None else mc.shard_batch(b.images, b.valid)
        staged.append((torch.from_numpy(images).to(device),
                       torch.from_numpy(valid).to(device=device, dtype=torch.float32),
                       float(b.valid.sum())))
    return staged


def train_mdn_resnet(hp: HyperParams, data: DataPipeline,
                     test_data: Optional[DataPipeline] = None,
                     encoder: Optional[ResNetEncoder] = None, device: Optional[str] = None,
                     log: Log = None, figures_dir: Optional[str] = None,
                     logger: Any = None) -> TrainResult:
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

    On a mesh the heads hold K/M components a model rank (the full heads are
    made from the seed, then sharded) and the stage norms are replicated;
    the shards' partial feature gradients (B4's) are summed over the model
    axis before they reach the norms.

    Not ported: the K-chunked update of `pipeline/mdn_chunked.py` (a
    workaround for a smaller device memory; PERF.md has what the joint step
    takes on the H100)."""
    from vit_ad_tpu_torch.pipeline.eval import evaluate_mdn_resnet

    _check_unported(hp)
    stages = RESNET_MDN_STAGES
    if encoder is None:
        encoder = ResNetEncoder(hp.img_size, hp.dtypes,
                                generator=torch.Generator().manual_seed(hp.seed))
    if device is None:
        device = next(encoder.parameters()).device
    device = torch.device(device)
    mc = _mesh_setup(hp, device)
    encoder = encoder.to(device).eval()
    mean, std = data.compute_mean_std() if hp.centering else default_norm_stats()
    mean_t, std_t = (torch.as_tensor(a, dtype=torch.float32, device=device)
                     for a in (mean, std))

    with torch.device(device):
        init = torch.Generator(device=device).manual_seed(hp.seed)
        heads = torch.nn.ModuleList(
            GaussianMDN(STAGE_CHANNELS[i], hp.num_gaussians, dtypes=hp.dtypes, generator=init)
            for i in stages)
    if mc is not None:
        heads = mc.shard_params(heads)
        mc.replicate(encoder.norms)
    # what trains: the heads and the stage norms (the trunk and its BatchNorm
    # statistics never change; `encoder.state_dict()` carries them to a file)
    trainable = torch.nn.ModuleDict({"heads": heads, "norms": encoder.norms})
    opt = torch_adam(trainable.parameters(), hp.learning_rate, hp.weight_decay)
    noise = torch.Generator(device=device).manual_seed(hp.seed)
    train_batches = stage_image_batches(data.train_batches(hp.prefetch), device, mc)
    valid_batches = stage_image_batches(data.valid_batches(hp.prefetch), device, mc)

    def train_epoch(epoch: int):
        losses, weights = [], []
        for images, valid, w in train_batches:
            losses.append(mdn_resnet_train_step(encoder, heads, opt, images, valid, noise,
                                                mean_t, std_t, stages, mc))
            weights.append(w)
        return _weighted_mean(losses, weights, mc), float(sum(weights))

    def valid_epoch() -> float:
        losses, weights = [], []
        with torch.no_grad():
            for images, valid, w in valid_batches:
                losses.append(mdn_resnet_loss(encoder, heads, images, valid, None, mean_t,
                                              std_t, stages, mc))
                weights.append(w)
        return _weighted_mean(losses, weights, mc)

    history, epochs_ran, stopper = run_epochs(hp, train_epoch, valid_epoch,
                                              trainable.state_dict, log)
    if stopper.best_params is not None:
        trainable.load_state_dict(stopper.best_params)
    metrics = _evaluated(evaluate_mdn_resnet, test_data, log, encoder, heads, hp=hp, mean=mean,
                         std=std, stages=stages, figures_dir=figures_dir, logger=logger)
    return _result(heads, encoder, history, metrics, epochs_ran, stopper)


NF_RESNET_STAGES = (0, 1, 2)  # reference LearnerNF.py:252-267: stage maps 0 to 2


def stage_flow(hp: HyperParams, stage: int,
               generator: Optional[torch.Generator] = None) -> NormalizingFlow:
    """The flow of one ResNet stage map: its channels on its side² positions
    (JAX `train_nf_resnet` :1290, `loading._build_resnet_models` :131)."""
    return NormalizingFlow(num_channels=STAGE_CHANNELS[stage], img_size=hp.img_size,
                           num_patches=(hp.img_size // STAGE_SCALES[stage]) ** 2,
                           hidden_ratio=hp.hidden_ratio, flow_steps=hp.flow_steps,
                           generator=generator)


def nf_resnet_loss(encoder: ResNetEncoder, flows: Sequence[NormalizingFlow],
                   images_u8: torch.Tensor, valid: torch.Tensor, mean: Optional[torch.Tensor],
                   std: Optional[torch.Tensor],
                   stages: Sequence[int] = NF_RESNET_STAGES,
                   mc: Optional[MeshContext] = None) -> torch.Tensor:
    """The objective of `train_nf_resnet` (JAX `loss_fn` :1326): per stage,
    the masked mean over the valid rows of ½ Σ z² - logdet of its flow on
    the LayerNorm'd stage map, summed over the stages. The trunk runs without
    gradient; the stage norms and the flows differentiate."""
    from vit_ad_tpu_torch.pipeline.eval import resnet_stage_maps

    maps = resnet_stage_maps(encoder, images_u8, mean, std, stages)
    total = 0.0
    for m, flow in zip(maps, flows):
        z, logdet = flow.transform(m)
        total = total + _masked_mean(0.5 * torch.sum(z * z, dim=(1, 2, 3)) - logdet, valid, mc)
    return total


def nf_resnet_train_step(encoder: ResNetEncoder, flows: Sequence[NormalizingFlow],
                         opt: torch.optim.Optimizer, images_u8: torch.Tensor,
                         valid: torch.Tensor, mean: Optional[torch.Tensor],
                         std: Optional[torch.Tensor],
                         stages: Sequence[int] = NF_RESNET_STAGES,
                         mc: Optional[MeshContext] = None) -> torch.Tensor:
    """One joint optimizer step on one padded uint8 batch; returns the
    (detached) loss."""
    return optimizer_step(opt, lambda: nf_resnet_loss(encoder, flows, images_u8, valid, mean,
                                                      std, stages, mc), mc)


def train_nf_resnet(hp: HyperParams, data: DataPipeline,
                    test_data: Optional[DataPipeline] = None,
                    encoder: Optional[ResNetEncoder] = None, device: Optional[str] = None,
                    log: Log = None, figures_dir: Optional[str] = None,
                    logger: Any = None) -> TrainResult:
    """NF over ResNet stages 0-2: three flows, one per stage map (256 x 56²,
    512 x 28², 1024 x 14² channels at 224 px), their NLLs summed, one Adam
    over the flows and the encoder's stage LayerNorms (reference
    LearnerNF.train_with_resnet, src/pipeline/LearnerNF.py:237-381; JAX
    `train_nf_resnet` :1264).

    The trunk is frozen and stays in eval mode; the flows run in f32 on the
    compute-dtype stage maps. The flows are made on the CPU in stage order
    from one generator seeded with `hp.seed`, then moved to `device`. The
    uint8 batches are decoded once and kept on the device. Flows and stage
    norms end with the weights of the best validation epoch;
    `TrainResult.head` is the `nn.ModuleList` of the stage flows and
    `.encoder` the encoder with its trained norms (the trunk's BatchNorm
    statistics never change, and `encoder.state_dict()` carries them to a
    file). Stage norm 3 feeds no flow and keeps its init (torch Adam skips
    parameters without a gradient; the JAX optimizer also decays it)."""
    from vit_ad_tpu_torch.pipeline.eval import evaluate_nf_resnet

    _check_unported(hp)
    stages = NF_RESNET_STAGES
    if encoder is None:
        encoder = ResNetEncoder(hp.img_size, hp.dtypes,
                                generator=torch.Generator().manual_seed(hp.seed))
    if device is None:
        device = next(encoder.parameters()).device
    device = torch.device(device)
    mc = _mesh_setup(hp, device)
    encoder = encoder.to(device).eval()
    mean, std = data.compute_mean_std() if hp.centering else default_norm_stats()
    mean_t, std_t = (torch.as_tensor(a, dtype=torch.float32, device=device)
                     for a in (mean, std))
    init = torch.Generator().manual_seed(hp.seed)
    flows = torch.nn.ModuleList(stage_flow(hp, i, init) for i in stages).to(device)
    trainable = torch.nn.ModuleDict({"flows": flows, "norms": encoder.norms})
    if mc is not None:
        mc.replicate(trainable)
    opt = torch_adam(trainable.parameters(), hp.learning_rate, hp.weight_decay)
    train_batches = stage_image_batches(data.train_batches(hp.prefetch), device, mc)
    valid_batches = stage_image_batches(data.valid_batches(hp.prefetch), device, mc)

    def train_epoch(epoch: int):
        losses, weights = [], []
        for images, valid, w in train_batches:
            losses.append(nf_resnet_train_step(encoder, flows, opt, images, valid, mean_t,
                                               std_t, stages, mc))
            weights.append(w)
        return _weighted_mean(losses, weights, mc), float(sum(weights))

    def valid_epoch() -> float:
        losses, weights = [], []
        with torch.no_grad():
            for images, valid, w in valid_batches:
                losses.append(nf_resnet_loss(encoder, flows, images, valid, mean_t, std_t,
                                             stages, mc))
                weights.append(w)
        return _weighted_mean(losses, weights, mc)

    history, epochs_ran, stopper = run_epochs(hp, train_epoch, valid_epoch,
                                              trainable.state_dict, log)
    if stopper.best_params is not None:
        trainable.load_state_dict(stopper.best_params)
    metrics = _evaluated(evaluate_nf_resnet, test_data, log, encoder, flows, hp=hp, mean=mean,
                         std=std, stages=stages, figures_dir=figures_dir, logger=logger)
    return _result(flows, encoder, history, metrics, epochs_ran, stopper)


def recon_loss(recon: torch.Tensor, x: torch.Tensor, valid: torch.Tensor, use_ssim: bool = False,
               mse_weight: float = 1.0, ssim_weight: float = 0.0,
               mc: Optional[MeshContext] = None) -> torch.Tensor:
    """The recon objective on a padded batch (JAX `loss_fn` :536-559): the
    per-image mean squared error in f32, masked-mean over the valid rows; with
    `use_ssim`, `mse_weight·MSE + ssim_weight·(1 - masked mean SSIM)` (the
    reference's learn_ae_with_SSIM). recon and x are [B, H, W, 3]."""
    recon, x = recon.float(), x.float()
    loss = _masked_mean(torch.mean(torch.square(recon - x), dim=(1, 2, 3)), valid, mc)
    if use_ssim:
        s = ssim_per_image(recon.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), data_range=1.0)
        # on a mesh, 1 - (masked mean SSIM) is a data rank's part: its rows'
        # part of the mean, and 1 / D of the constant
        one = 1.0 if mc is None else 1.0 / mc.data_size
        loss = mse_weight * loss + ssim_weight * (one - _masked_mean(s, valid, mc))
    return loss


def reconstruct(model: torch.nn.Module, x: torch.Tensor,
                latents: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The AE's reconstruction [B, H, W, 3] of the preprocessed x; with the
    cached trunk latents of a transformer AE, the decoder alone."""
    if latents is None:
        return model(x).reconstruction
    return model.decoder(latents).permute(0, 2, 3, 1)


def recon_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer, images_u8: torch.Tensor,
                     valid: torch.Tensor, latents: Optional[torch.Tensor],
                     mean: Optional[torch.Tensor], std: Optional[torch.Tensor],
                     use_ssim: bool = False, mse_weight: float = 1.0,
                     ssim_weight: float = 0.0,
                     mc: Optional[MeshContext] = None) -> torch.Tensor:
    """One optimizer step of `train_recon` on one padded uint8 batch (model in
    train mode: the decoder's BatchNorms take batch statistics and update
    their running ones); returns the (detached) loss."""

    def loss() -> torch.Tensor:
        x = preprocess(images_u8, mean, std)
        return recon_loss(reconstruct(model, x, latents), x, valid, use_ssim, mse_weight,
                          ssim_weight, mc)

    return optimizer_step(opt, loss, mc)


def cache_latents(model: TransformerAutoEncoder,
                  batches: Sequence[Tuple[torch.Tensor, torch.Tensor, float]],
                  mean: Optional[torch.Tensor], std: Optional[torch.Tensor]) -> List[torch.Tensor]:
    """The frozen trunk's latents [B, D] of every staged batch, in eval mode
    and without gradient (JAX :593-645); a padded row's latent is the last
    valid row's. (On a mesh a data rank whose rows are all padding keeps the
    latents of its images, which the loader padded with the last valid
    image.)"""
    out = []
    for images, valid, _ in batches:
        z = model.latent(preprocess(images, mean, std)).clone()
        n = int(valid.sum())
        if n:
            z[n:] = z[n - 1]
        out.append(z)
    return out


def train_recon(hp: HyperParams, data: DataPipeline, test_data: Optional[DataPipeline] = None,
                model: Optional[torch.nn.Module] = None, use_ssim: bool = False,
                device: Optional[str] = None, log: Log = None,
                figures_dir: Optional[str] = None, logger: Any = None) -> TrainResult:
    """Train a reconstruction auto-encoder (reference
    LearnerRecon.learn_ae_with_MSE_only; `use_ssim` learn_ae_with_SSIM).

    `model` defaults to the registry AE of `hp.model_name` with its seeded
    init; it lives on `device` (default: its own). Torch-semantics Adam over
    the whole AE for `VanillaAutoEncoder`, over the decoder otherwise (the
    frozen encoder stays in eval mode). The loss is `recon_loss`; the
    validation loss is the masked MSE in eval mode. A transformer AE's trunk
    runs once over the train and validation batches (`cache_latents`), and
    each step and validation pass runs the decoder alone. The uint8 batches
    are decoded once and kept on the device. The AE ends with the weights and
    running statistics of its best validation epoch, in eval mode, and is
    evaluated on `test_data`. `TrainResult.head` is the AE. On a mesh the
    decoder (the vanilla AE whole) is replicated and its BatchNorms take
    global-batch statistics in training; a transformer AE's frozen trunk is
    sharded over a model axis above one."""
    from vit_ad_tpu_torch.pipeline.eval import evaluate_recon

    _check_unported(hp)
    if model is None:
        model = default_encoder(hp)
    if device is None:
        device = next(model.parameters()).device
    device = torch.device(device)
    mc = _mesh_setup(hp, device)
    model = model.to(device)
    if mc is not None:
        model = mc.shard_params(model)
    mean, std = data.compute_mean_std() if hp.centering else default_norm_stats()
    mean_t, std_t = (torch.as_tensor(a, dtype=torch.float32, device=device) for a in (mean, std))
    # the vanilla AE trains end to end; a pretrained encoder stays frozen
    trainable = model if isinstance(model, VanillaAutoEncoder) else model.decoder
    if mc is not None:
        mc.replicate(trainable)
    opt = torch_adam(trainable.parameters(), hp.learning_rate, hp.weight_decay)
    train_batches = stage_image_batches(data.train_batches(hp.prefetch), device, mc)
    valid_batches = stage_image_batches(data.valid_batches(hp.prefetch), device, mc)
    train_latents = valid_latents = None
    if isinstance(model, TransformerAutoEncoder):
        model.eval()
        train_latents = cache_latents(model, train_batches, mean_t, std_t)
        valid_latents = cache_latents(model, valid_batches, mean_t, std_t)
    weights = (hp.mse_weight, hp.ssim_weight) if use_ssim else (1.0, 0.0)

    def train_epoch(epoch: int):
        model.train()
        losses, counts = [], []
        for i, (images, valid, w) in enumerate(train_batches):
            z = None if train_latents is None else train_latents[i]
            losses.append(recon_train_step(model, opt, images, valid, z, mean_t, std_t,
                                           use_ssim, *weights, mc=mc))
            counts.append(w)
        return _weighted_mean(losses, counts, mc), float(sum(counts))

    def valid_epoch() -> float:
        model.eval()
        losses, counts = [], []
        with torch.no_grad():
            for i, (images, valid, w) in enumerate(valid_batches):
                z = None if valid_latents is None else valid_latents[i]
                x = preprocess(images, mean_t, std_t)
                losses.append(recon_loss(reconstruct(model, x, z), x, valid, mc=mc))
                counts.append(w)
        return _weighted_mean(losses, counts, mc)

    history, epochs_ran, stopper = run_epochs(hp, train_epoch, valid_epoch,
                                              trainable.state_dict, log)
    if stopper.best_params is not None:
        trainable.load_state_dict(stopper.best_params)
    model.eval()
    metrics = _evaluated(evaluate_recon, test_data, log, model, hp=hp, mean=mean, std=std,
                         figures_dir=figures_dir, logger=logger)
    return _result(model, None, history, metrics, epochs_ran, stopper)


def vae_loss(model: VariationalAutoEncoder, images_u8: torch.Tensor, valid: torch.Tensor,
             mean: Optional[torch.Tensor], std: Optional[torch.Tensor],
             generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None,
             mc: Optional[MeshContext] = None) -> torch.Tensor:
    """The VAE objective on a padded uint8 batch (JAX `loss_fn` :1488-1509):
    the per-image mean squared error in f32 plus the per-image KL, each a
    masked mean over the valid rows, from ONE encode (its BatchNorms in
    whichever mode the model is in); ε is `eps`, else drawn from
    `generator` (on a mesh, the global batch's draw, this rank's rows
    kept)."""
    x = preprocess(images_u8, mean, std)
    if eps is None and mc is not None:
        eps = mc.draw_rows(torch.randn, (x.shape[0], model.latent_dim), generator=generator,
                           device=x.device)
    out, mu, log_var = model.forward_with_posterior(x, eps, generator)
    err = torch.mean(torch.square(out.reconstruction.float() - x.float()), dim=(1, 2, 3))
    return _masked_mean(err, valid, mc) + _masked_mean(kl_per_example(mu, log_var), valid, mc)


def vae_train_step(model: VariationalAutoEncoder, opt: torch.optim.Optimizer,
                   images_u8: torch.Tensor, valid: torch.Tensor, mean: Optional[torch.Tensor],
                   std: Optional[torch.Tensor], generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None,
                   mc: Optional[MeshContext] = None) -> torch.Tensor:
    """One optimizer step of `train_vae` (model in train mode: the
    BatchNorms take batch statistics and update their running ones); returns
    the (detached) loss."""
    return optimizer_step(opt, lambda: vae_loss(model, images_u8, valid, mean, std, generator,
                                                eps, mc), mc)


def train_vae(hp: HyperParams, data: DataPipeline, test_data: Optional[DataPipeline] = None,
              model: Optional[VariationalAutoEncoder] = None, device: Optional[str] = None,
              log: Log = None, figures_dir: Optional[str] = None,
              logger: Any = None) -> TrainResult:
    """Train the variational auto-encoder end to end: loss = masked MSE +
    masked KL (reference LearnerRecon.learn_vae, LearnerRecon.py:165-276,
    dead code there; JAX `train_vae` :1454).

    `model` defaults to a `VariationalAutoEncoder` at `hp.img_size` with its
    init seeded by `hp.seed`; it lives on `device` (default: its own).
    Torch-semantics Adam over all of it; ε of every training and validation
    batch comes from one generator seeded with `hp.seed` on the run's
    device; the validation loss is the same objective in eval mode. The
    uint8 batches are decoded once and kept on the device. The model ends
    with the weights and running statistics of its best validation epoch, in
    eval mode, and is evaluated by decoding the posterior mean
    (`pipeline.eval.evaluate_vae`). `TrainResult.head` is the model. On a
    mesh it is replicated and its BatchNorms take global-batch statistics in
    training."""
    from vit_ad_tpu_torch.pipeline.eval import evaluate_vae

    _check_unported(hp)
    if model is None:
        model = VariationalAutoEncoder(hp.img_size, dtypes=hp.dtypes,
                                       generator=torch.Generator().manual_seed(hp.seed))
    if device is None:
        device = next(model.parameters()).device
    device = torch.device(device)
    mc = _mesh_setup(hp, device)
    model = model.to(device)
    if mc is not None:
        model = mc.shard_params(mc.replicate(model))
    mean, std = data.compute_mean_std() if hp.centering else default_norm_stats()
    mean_t, std_t = (torch.as_tensor(a, dtype=torch.float32, device=device) for a in (mean, std))
    opt = torch_adam(model.parameters(), hp.learning_rate, hp.weight_decay)
    noise = torch.Generator(device=device).manual_seed(hp.seed)
    train_batches = stage_image_batches(data.train_batches(hp.prefetch), device, mc)
    valid_batches = stage_image_batches(data.valid_batches(hp.prefetch), device, mc)

    def train_epoch(epoch: int):
        model.train()
        losses, counts = [], []
        for images, valid, w in train_batches:
            losses.append(vae_train_step(model, opt, images, valid, mean_t, std_t, noise,
                                         mc=mc))
            counts.append(w)
        return _weighted_mean(losses, counts, mc), float(sum(counts))

    def valid_epoch() -> float:
        model.eval()
        losses, counts = [], []
        with torch.no_grad():
            for images, valid, w in valid_batches:
                losses.append(vae_loss(model, images, valid, mean_t, std_t, noise, mc=mc))
                counts.append(w)
        return _weighted_mean(losses, counts, mc)

    history, epochs_ran, stopper = run_epochs(hp, train_epoch, valid_epoch, model.state_dict,
                                              log)
    if stopper.best_params is not None:
        model.load_state_dict(stopper.best_params)
    model.eval()
    metrics = _evaluated(evaluate_vae, test_data, log, model, hp=hp, mean=mean, std=std,
                         figures_dir=figures_dir, logger=logger)
    return _result(model, None, history, metrics, epochs_ran, stopper)
