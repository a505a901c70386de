"""Host score tail: concatenated per-batch payloads → (image_scores,
pixel_scores). Port of `vit_ad_tpu/scoring.py`: numpy plus the port's
bilinear resize, run on the CPU. Also the in-graph image-score tail of a
scores-only serving bundle (`scores_tail`, port of
`vit_ad_tpu/serving/aot.py::_scores_tail` :124). Light on purpose: a serving
site imports it with torch and numpy only."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from vit_ad_tpu_torch.ops.resize import interpolate_bilinear


def ll_to_anomaly_maps(ll: np.ndarray, img_size: int, ref_max: Optional[float] = None):
    """The MDN score core (JAX `scoring.ll_to_anomaly_maps` :25): global-max
    probability normalization (or a fixed `ref_max`, clamping prob at 1),
    sqrt-side reshape, bilinear upsample with align_corners=True and the
    `(x * -1) + 1` inversion. Returns (anomaly_maps [N, H, W], prob [N, P])."""
    m = ll.max() if ref_max is None else float(ref_max)
    prob = np.exp(np.minimum(ll - m, 0.0))
    side = int(round(np.sqrt(prob.shape[1])))
    grid = np.ascontiguousarray(prob.reshape(-1, side, side), dtype=np.float32)
    up = interpolate_bilinear(torch.from_numpy(grid), img_size, img_size,
                              align_corners=True).numpy()
    return (up * -1.0) + 1.0, prob


def payload_to_scores(kind: str, payload, img_size: int,
                      ref_max_ll: Optional[Sequence[float]] = None):
    """Per kind (JAX `payload_to_scores` :56):
      * mdn        — [N, P] log-liks; image score = inverted min patch prob
      * mdn_resnet — per-stage log-liks → mean of the stage maps; score = max
      * nf / nf_resnet / recon — [N, H, W] anomaly maps; score = max
    """
    if kind == "mdn":
        rm = None if ref_max_ll is None else ref_max_ll[0]
        pixel_scores, prob = ll_to_anomaly_maps(payload, img_size, rm)
        return (prob.min(axis=1) * -1.0) + 1.0, pixel_scores
    if kind == "mdn_resnet":
        rms = [None] * len(payload) if ref_max_ll is None else list(ref_max_ll)
        stage_maps = [ll_to_anomaly_maps(np.asarray(p), img_size, rm)[0]
                      for p, rm in zip(payload, rms)]
        pixel_scores = np.mean(np.stack(stage_maps, -1), axis=-1)
        return pixel_scores.reshape(pixel_scores.shape[0], -1).max(axis=1), pixel_scores
    if kind in ("nf", "nf_resnet", "recon"):
        maps = np.asarray(payload)
        return maps.reshape(maps.shape[0], -1).max(axis=1), maps
    raise ValueError(f"unknown score kind {kind!r}")


def payload_ref_max_ll(kind: str, payload) -> Optional[list]:
    """Per-stage max log-likelihoods of a payload set (JAX
    `payload_ref_max_ll` :94): the fixed MDN normalizer a serving bundle
    bakes (computed over e.g. the training images at export time). None for
    kinds without one."""
    if kind == "mdn":
        return [float(np.asarray(payload).max())]
    if kind == "mdn_resnet":
        return [float(np.asarray(p).max()) for p in payload]
    return None


def scores_tail(kind: str, img_size: int, ref_max_ll: Optional[Sequence[float]]):
    """The payload → [B] image-score tail as torch ops, for the graph of a
    scores-only bundle, with `payload_to_scores`'s image-score semantics.
    MDN kinds need the baked normalizer `ref_max_ll` (a per-call-set max
    cannot live inside a fixed per-chunk graph) and raise without it."""
    if kind in ("nf", "nf_resnet", "recon"):
        def tail(payload: torch.Tensor) -> torch.Tensor:
            maps = payload.float()
            return torch.amax(maps.reshape(maps.shape[0], -1), dim=1)

        return tail
    if kind not in ("mdn", "mdn_resnet"):
        raise ValueError(f"unknown score kind {kind!r}")
    if ref_max_ll is None:
        raise ValueError(
            "payload='scores' for MDN kinds needs ref_images (the baked "
            "max-log-likelihood normalizer): per-call-set normalization "
            "cannot live inside a fixed per-chunk graph")
    rms = [float(r) for r in ref_max_ll]

    def prob(ll: torch.Tensor, rm: float) -> torch.Tensor:
        return torch.exp(torch.clamp(ll.float() - rm, max=0.0))

    if kind == "mdn":
        def tail(ll: torch.Tensor) -> torch.Tensor:
            return (torch.amin(prob(ll, rms[0]), dim=1) * -1.0) + 1.0

        return tail

    def tail(payload) -> torch.Tensor:
        anoms = []
        for ll, rm in zip(payload, rms):
            p = prob(ll, rm)
            side = int(round(float(np.sqrt(p.shape[1]))))
            up = interpolate_bilinear(p.reshape(-1, side, side), img_size, img_size,
                                      align_corners=True)
            anoms.append((up * -1.0) + 1.0)
        pix = torch.mean(torch.stack(anoms, -1), dim=-1)
        return torch.amax(pix.reshape(pix.shape[0], -1), dim=1)

    return tail
