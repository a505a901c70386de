"""Scoring: models → anomaly maps → image scores → metrics (port of
`vit_ad_tpu/pipeline/eval.py`: `make_mdn_batch_fn` :357, `score_mdn` :446,
`evaluate_mdn` :482, `make_nf_batch_fn` :371, `score_nf` :500, `evaluate_nf`
:532, `make_mdn_resnet_batch_fn` :401, `score_mdn_resnet` :608,
`evaluate_mdn_resnet` :651, `make_recon_batch_fn` :388, `score_recon` :550,
`evaluate_recon` :579 and the metrics half of `_metrics_and_figures` :55;
figures are ROADMAP A10, the NF-ResNet evaluators A7b).

  * MDN — per-patch mean log-likelihood; image score = inverted min patch
    probability, normalized by the max log-likelihood over the whole scored
    set (reference ValidatorMDN.py:104-185, with the JAX package's global-max
    fix; `scoring.payload_to_scores("mdn")`).
  * NF — anomaly map from the flow forward; image score = max over the map
    (reference ValidatorNF.py:137-142).
  * MDN over ResNet stages — one head per stage map; per-stage probability
    maps upsampled, inverted and averaged; image score = max
    (`scoring.payload_to_scores("mdn_resnet")`).
  * Reconstruction — anomaly map = the channel mean of the squared error
    between the auto-encoder's reconstruction and its preprocessed input;
    image score = max (reference ValidatorRecon.py:92-136).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vit_ad_tpu_torch.config import HyperParams
from vit_ad_tpu_torch.data.loader import Batch, DataPipeline, preprocess
from vit_ad_tpu_torch.models.flow import NormalizingFlow, patch_tokens_to_map
from vit_ad_tpu_torch.models.mdn import GaussianMDN
from vit_ad_tpu_torch.models.outputs import Encoder
from vit_ad_tpu_torch.models.resnet import ResNetEncoder
from vit_ad_tpu_torch.pipeline import metrics as M
from vit_ad_tpu_torch.scoring import payload_to_scores


class ScoreOutput(NamedTuple):
    """Label-free scoring payload (JAX `ScoreOutput`)."""

    image_scores: np.ndarray            # [N] anomaly score per image
    pixel_scores: np.ndarray            # [N, H, W] anomaly map per image
    labels: np.ndarray                  # [N] path-inferred 0/1
    masks: np.ndarray                   # [N, H, W] ground-truth or zeros


def _as_device(a: Optional[np.ndarray], device: torch.device) -> Optional[torch.Tensor]:
    return None if a is None else torch.as_tensor(a, dtype=torch.float32, device=device)


def metrics_of(s: ScoreOutput, hp: HyperParams) -> Dict[str, float]:
    """The reference metric suite of a labelled ScoreOutput."""
    return M.calc_all_metrics(M.EvalResult(
        image_scores=s.image_scores, image_labels=s.labels.astype(np.float64),
        pixel_scores=s.pixel_scores, pixel_labels=s.masks.astype(np.float64)),
        hp.fp_threshold)


def make_mdn_batch_fn(encoder: Encoder, mdn: GaussianMDN, hp: HyperParams,
                      mean: Optional[torch.Tensor], std: Optional[torch.Tensor]
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Per-batch MDN scorer: uint8 images [B, H, W, 3] on the models' device
    → per-patch mean log-likelihood [B, P] (the device half of
    `score_mdn`). The mixture weights are the deterministic softmax; the
    log-likelihood is the GMM kernel (B2) on the card."""

    def loglik_map(images_u8: torch.Tensor) -> torch.Tensor:
        x = preprocess(images_u8, mean, std)
        feats = encoder(x, block_index=hp.block_index).patch_embedding
        return torch.mean(mdn.log_likelihood(feats), dim=2)

    return loglik_map


def score_mdn(encoder: Encoder, mdn: GaussianMDN, test_data: DataPipeline,
              hp: HyperParams, mean: Optional[np.ndarray] = None,
              std: Optional[np.ndarray] = None) -> ScoreOutput:
    """MDN scoring pipeline on the device the models live on. Scores are
    comparable within one call (global-max normalization over the set)."""
    device = next(encoder.parameters()).device
    fn = make_mdn_batch_fn(encoder, mdn, hp, _as_device(mean, device), _as_device(std, device))
    ll, labels, masks = _collect(test_data.test_batches(hp.prefetch), fn, device)
    image_scores, pixel_scores = payload_to_scores("mdn", ll, hp.img_size)
    return ScoreOutput(image_scores, pixel_scores, labels, masks)


def evaluate_mdn(encoder: Encoder, mdn: GaussianMDN, test_data: DataPipeline,
                 hp: HyperParams, mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None) -> Dict[str, float]:
    """score_mdn + the reference metric suite."""
    return metrics_of(score_mdn(encoder, mdn, test_data, hp, mean, std), hp)


def make_nf_batch_fn(encoder: Encoder, flow: NormalizingFlow, hp: HyperParams,
                     mean: Optional[torch.Tensor], std: Optional[torch.Tensor]
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Per-batch NF scorer: uint8 images [B, H, W, 3] on the models' device →
    anomaly maps [B, H, W] f32 (the device half of `score_nf`)."""

    def anomaly_maps(images_u8: torch.Tensor) -> torch.Tensor:
        x = preprocess(images_u8, mean, std)
        feats = encoder(x, block_index=hp.block_index).patch_embedding
        return flow(patch_tokens_to_map(feats)).anomaly_score_map

    return anomaly_maps


def _collect(batches: Iterable[Batch],
             score_fn: Callable[[torch.Tensor], Union[torch.Tensor, Tuple[torch.Tensor, ...]]],
             device: torch.device):
    """Score every batch; return (payloads, labels, masks) with the padded
    rows trimmed. A `score_fn` that returns a tuple (one output per stage)
    gives a tuple of concatenated payloads."""
    payloads, labels, masks = [], [], []
    per_stage = False
    for batch in batches:
        n = int(batch.valid.sum())
        with torch.inference_mode():
            out = score_fn(torch.from_numpy(batch.images).to(device))
            per_stage = isinstance(out, tuple)
            payloads.append([o[:n].float().cpu().numpy() for o in (out if per_stage else (out,))])
        labels.append(batch.labels[:n])
        masks.append(batch.masks[:n])
    if not payloads:
        raise ValueError("no batches to score")
    cat = tuple(np.concatenate(stage) for stage in zip(*payloads))
    return cat if per_stage else cat[0], np.concatenate(labels), np.concatenate(masks)


def score_nf(encoder: Encoder, flow: NormalizingFlow, test_data: DataPipeline,
             hp: HyperParams, mean: Optional[np.ndarray] = None,
             std: Optional[np.ndarray] = None) -> ScoreOutput:
    """NF scoring pipeline on the device the models live on."""
    device = next(encoder.parameters()).device
    anomaly_maps = make_nf_batch_fn(encoder, flow, hp, _as_device(mean, device),
                                    _as_device(std, device))
    maps, labels, masks = _collect(test_data.test_batches(hp.prefetch), anomaly_maps, device)
    image_scores, maps = payload_to_scores("nf", maps, hp.img_size)
    return ScoreOutput(image_scores, maps, labels, masks)


def evaluate_nf(encoder: Encoder, flow: NormalizingFlow, test_data: DataPipeline,
                hp: HyperParams, mean: Optional[np.ndarray] = None,
                std: Optional[np.ndarray] = None) -> Dict[str, float]:
    """score_nf + the reference metric suite."""
    return metrics_of(score_nf(encoder, flow, test_data, hp, mean, std), hp)


def resnet_stage_tokens(encoder: ResNetEncoder, images_u8: torch.Tensor,
                        mean: Optional[torch.Tensor], std: Optional[torch.Tensor],
                        stages: Sequence[int]) -> List[torch.Tensor]:
    """uint8 images → the LayerNorm'd maps of `stages` as tokens [B, h*w, C]
    (the trunk without gradient, the stage norms with)."""
    x = preprocess(images_u8, mean, std)
    return [m.flatten(1, 2) for m in encoder.stage_features(x, stages)]


def make_mdn_resnet_batch_fn(encoder: ResNetEncoder, mdns: Sequence[GaussianMDN],
                             hp: HyperParams, mean: Optional[torch.Tensor],
                             std: Optional[torch.Tensor], stages: Sequence[int] = (2, 3)
                             ) -> Callable[[torch.Tensor], Tuple[torch.Tensor, ...]]:
    """Per-batch multi-stage MDN scorer: uint8 images [B, H, W, 3] on the
    models' device → one [B, h*w] per-patch mean log-likelihood per stage (the
    device half of `score_mdn_resnet`); the GMM kernel (B2) once per stage on
    the card."""

    def stage_logliks(images_u8: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        tokens = resnet_stage_tokens(encoder, images_u8, mean, std, stages)
        return tuple(torch.mean(mdn.log_likelihood(feats), dim=2)
                     for feats, mdn in zip(tokens, mdns))

    return stage_logliks


def score_mdn_resnet(encoder: ResNetEncoder, mdns: Sequence[GaussianMDN],
                     test_data: DataPipeline, hp: HyperParams,
                     mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None,
                     stages: Sequence[int] = (2, 3)) -> ScoreOutput:
    """Multi-stage MDN scoring (reference ValidatorMdn.valid_loop_resnet):
    per-stage probability maps are upsampled (align_corners=True), inverted
    to anomaly and averaged. As in the JAX package, and unlike the reference:
    probabilities are normalized by the max over the whole scored set, not
    per batch, and the image score is the max over the averaged anomaly map
    (the reference takes min-then-reinvert, a double inversion)."""
    device = next(encoder.parameters()).device
    fn = make_mdn_resnet_batch_fn(encoder, mdns, hp, _as_device(mean, device),
                                  _as_device(std, device), stages)
    stage_lls, labels, masks = _collect(test_data.test_batches(hp.prefetch), fn, device)
    image_scores, pixel_scores = payload_to_scores("mdn_resnet", stage_lls, hp.img_size)
    return ScoreOutput(image_scores, pixel_scores, labels, masks)


def evaluate_mdn_resnet(encoder: ResNetEncoder, mdns: Sequence[GaussianMDN],
                        test_data: DataPipeline, hp: HyperParams,
                        mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None,
                        stages: Sequence[int] = (2, 3)) -> Dict[str, float]:
    """score_mdn_resnet + the reference metric suite."""
    return metrics_of(score_mdn_resnet(encoder, mdns, test_data, hp, mean, std, stages), hp)


def make_recon_batch_fn(model: torch.nn.Module, mean: Optional[torch.Tensor],
                        std: Optional[torch.Tensor]) -> Callable[[torch.Tensor], torch.Tensor]:
    """Per-batch recon scorer: uint8 images [B, H, W, 3] on the model's device
    → the channel-mean squared error [B, H, W] f32 against the preprocessed
    input (the device half of `score_recon`). The model must be in eval mode
    when it is called (the JAX scorer's `train=False`: BatchNorms on their
    running statistics, which a training-mode call would also move)."""

    def error_maps(images_u8: torch.Tensor) -> torch.Tensor:
        if model.training:
            raise ValueError("recon scoring: the auto-encoder must be in eval mode")
        x = preprocess(images_u8, mean, std)
        recon = model(x).reconstruction
        return torch.mean(torch.square(recon.float() - x.float()), dim=-1)

    return error_maps


def score_recon(model: torch.nn.Module, test_data: DataPipeline, hp: HyperParams,
                mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None
                ) -> ScoreOutput:
    """Reconstruction scoring on the device the model lives on."""
    device = next(model.parameters()).device
    fn = make_recon_batch_fn(model, _as_device(mean, device), _as_device(std, device))
    maps, labels, masks = _collect(test_data.test_batches(hp.prefetch), fn, device)
    image_scores, maps = payload_to_scores("recon", maps, hp.img_size)
    return ScoreOutput(image_scores, maps, labels, masks)


def evaluate_recon(model: torch.nn.Module, test_data: DataPipeline, hp: HyperParams,
                   mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None
                   ) -> Dict[str, float]:
    """score_recon + the reference metric suite."""
    return metrics_of(score_recon(model, test_data, hp, mean, std), hp)
