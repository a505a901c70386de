"""Frozen-encoder feature extraction with caching (port of
`vit_ad_tpu/pipeline/features.py`: `make_feature_extractor` :23,
`extract_features` :47, `stage_feature_batches` :91).

The encoder never changes while a head trains, so features are extracted
once per run and the head trains on the cached [N, P, D] array, staged on
the device once as padded batches. On a mesh each data rank extracts and
caches the features of its own rows of every padded batch, with the trunk
replicated (`shard_feature_batches`). The JAX package's scan-of-batches
epoch machinery exists to amortize TPU dispatch and is not ported.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from vit_ad_tpu_torch.data.loader import Batch, preprocess
from vit_ad_tpu_torch.models.outputs import Encoder
from vit_ad_tpu_torch.pipeline.eval import _as_device


def make_feature_extractor(encoder: Encoder, block_index: int = 0,
                           mean: Optional[np.ndarray] = None,
                           std: Optional[np.ndarray] = None
                           ) -> Callable[[torch.Tensor], torch.Tensor]:
    """uint8 images [B, H, W, 3] on the encoder's device → patch embeddings
    [B, P, D] f32."""
    device = next(encoder.parameters()).device
    mean_t, std_t = _as_device(mean, device), _as_device(std, device)

    def fn(images_u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            x = preprocess(images_u8, mean_t, std_t)
            return encoder(x, block_index=block_index).patch_embedding.float()

    return fn


def extract_features(extractor: Callable[[torch.Tensor], torch.Tensor],
                     batches: Iterable[Batch], device: torch.device) -> torch.Tensor:
    """Run the extractor over a batch stream, dropping padded rows; the
    features [N, P, D] stay on `device`."""
    chunks = []
    for batch in batches:
        n = int(batch.valid.sum())
        chunks.append(extractor(torch.from_numpy(batch.images).to(device))[:n])
    if not chunks:
        raise ValueError("no batches to extract features from")
    return torch.cat(chunks)  # outside inference mode: a normal tensor


def stage_feature_batches(features: torch.Tensor, batch_size: int
                          ) -> Callable[[], Iterator[Tuple[torch.Tensor, torch.Tensor, float]]]:
    """Padded epoch batches of the cached features, made once on their
    device: a re-iterable of (feats [B, P, D], valid [B] f32, valid count).
    The last batch repeats its last row, as the JAX package pads."""
    staged: List[Tuple[torch.Tensor, torch.Tensor, float]] = []
    n = features.shape[0]
    for start in range(0, n, batch_size):
        feats = features[start:start + batch_size]
        k = feats.shape[0]
        valid = torch.ones(batch_size, dtype=torch.float32, device=features.device)
        if k < batch_size:
            feats = torch.cat([feats, feats[-1:].expand(batch_size - k, *feats.shape[1:])])
            valid[k:] = 0.0
        staged.append((feats.contiguous(), valid, float(k)))
    return lambda: iter(staged)


def shard_feature_batches(extractor: Callable[[torch.Tensor], torch.Tensor],
                          batches: Iterable[Batch], device: torch.device, mc: Any
                          ) -> Callable[[], Iterator[Tuple[torch.Tensor, torch.Tensor, float]]]:
    """On the mesh of `mc` (a `parallel.context.MeshContext`): this data
    rank's rows of every padded batch through the extractor, staged on
    `device` once: a re-iterable of (feats [B/D, P, D], valid [B/D] f32, the
    batch's global valid count), the rows `stage_feature_batches` would give
    this rank of the same batches."""
    staged: List[Tuple[torch.Tensor, torch.Tensor, float]] = []
    for batch in batches:
        images, valid = mc.shard_batch(batch.images, batch.valid)
        feats = extractor(torch.from_numpy(images).to(device)).clone()  # a normal tensor
        staged.append((feats, torch.from_numpy(valid).to(device=device, dtype=torch.float32),
                       float(batch.valid.sum())))
    if not staged:
        raise ValueError("no batches to extract features from")
    return lambda: iter(staged)


def gather_features(batches: Callable[[], Iterator[Tuple[torch.Tensor, torch.Tensor, float]]],
                    mc: Any) -> torch.Tensor:
    """The valid rows of every data rank's staged batches, in order: the
    [N, P, D] features `extract_features` gives one device."""
    return torch.cat([torch.cat(mc.gather_rows(feats))[:int(n)] for feats, _, n in batches()])
