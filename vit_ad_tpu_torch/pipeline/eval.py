"""NF scoring: models → anomaly maps → image scores (port of
`vit_ad_tpu/pipeline/eval.py` `make_nf_batch_fn` :371 and `score_nf` :500;
the MDN, recon and ResNet evaluators and the metric suite are ROADMAP A4-A8).

NF semantics (reference ValidatorNF.py:107-150): anomaly map from the flow
forward; image score = max over the map (:137-142).
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vit_ad_tpu_torch.config import HyperParams
from vit_ad_tpu_torch.data.loader import Batch, DataPipeline, preprocess
from vit_ad_tpu_torch.models.flow import NormalizingFlow, patch_tokens_to_map
from vit_ad_tpu_torch.models.vit import ViTEncoder
from vit_ad_tpu_torch.scoring import payload_to_scores


class ScoreOutput(NamedTuple):
    """Label-free scoring payload (JAX `ScoreOutput`)."""

    image_scores: np.ndarray            # [N] anomaly score per image
    pixel_scores: np.ndarray            # [N, H, W] anomaly map per image
    labels: np.ndarray                  # [N] path-inferred 0/1
    masks: np.ndarray                   # [N, H, W] ground-truth or zeros


def make_nf_batch_fn(encoder: ViTEncoder, flow: NormalizingFlow, hp: HyperParams,
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


def score_nf(encoder: ViTEncoder, flow: NormalizingFlow, test_data: DataPipeline,
             hp: HyperParams, mean: Optional[np.ndarray] = None,
             std: Optional[np.ndarray] = None) -> ScoreOutput:
    """NF scoring pipeline on the device the models live on."""
    device = next(encoder.parameters()).device
    as_t = lambda a: None if a is None else torch.as_tensor(a, dtype=torch.float32,
                                                           device=device)
    anomaly_maps = make_nf_batch_fn(encoder, flow, hp, as_t(mean), as_t(std))
    maps, labels, masks = _collect(test_data.test_batches(hp.prefetch), anomaly_maps, device)
    image_scores, maps = payload_to_scores("nf", maps, hp.img_size)
    return ScoreOutput(image_scores, maps, labels, masks)
