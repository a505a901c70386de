"""Scoring: models → anomaly maps → image scores → metrics (port of
`vit_ad_tpu/pipeline/eval.py`: `make_mdn_batch_fn` :357, `score_mdn` :446,
`evaluate_mdn` :482, `make_nf_batch_fn` :371, `score_nf` :500, `evaluate_nf`
:532 and the metrics half of `_metrics_and_figures` :55; figures are ROADMAP
A10, the recon and ResNet evaluators A7/A8).

  * MDN — per-patch mean log-likelihood; image score = inverted min patch
    probability, normalized by the max log-likelihood over the whole scored
    set (reference ValidatorMDN.py:104-185, with the JAX package's global-max
    fix; `scoring.payload_to_scores("mdn")`).
  * NF — anomaly map from the flow forward; image score = max over the map
    (reference ValidatorNF.py:137-142).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vit_ad_tpu_torch.config import HyperParams
from vit_ad_tpu_torch.data.loader import Batch, DataPipeline, preprocess
from vit_ad_tpu_torch.models.flow import NormalizingFlow, patch_tokens_to_map
from vit_ad_tpu_torch.models.mdn import GaussianMDN
from vit_ad_tpu_torch.models.outputs import Encoder
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


def _collect(batches: Iterable[Batch], score_fn: Callable[[torch.Tensor], torch.Tensor],
             device: torch.device) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Score every batch; return (payloads, labels, masks) with the padded
    rows trimmed."""
    payloads, labels, masks = [], [], []
    for batch in batches:
        n = int(batch.valid.sum())
        with torch.inference_mode():
            out = score_fn(torch.from_numpy(batch.images).to(device))
            payloads.append(out[:n].float().cpu().numpy())
        labels.append(batch.labels[:n])
        masks.append(batch.masks[:n])
    if not payloads:
        raise ValueError("no batches to score")
    return np.concatenate(payloads), np.concatenate(labels), np.concatenate(masks)


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
