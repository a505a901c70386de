"""Scoring: models → anomaly maps → image scores → metrics and figures (port
of `vit_ad_tpu/pipeline/eval.py`: `make_mdn_batch_fn` :357, `score_mdn` :446,
`evaluate_mdn` :482, `make_nf_batch_fn` :371, `score_nf` :500, `evaluate_nf`
:532, `make_mdn_resnet_batch_fn` :401, `score_mdn_resnet` :608,
`evaluate_mdn_resnet` :651, `make_nf_resnet_batch_fn` :425, `score_nf_resnet`
:671, `evaluate_nf_resnet` :705, `make_recon_batch_fn` :388, `score_recon`
:550, `evaluate_recon` :579, `_metrics_and_figures` :55 and
`save_eval_figures` :243).

  * MDN — per-patch mean log-likelihood; image score = inverted min patch
    probability, normalized by the max log-likelihood over the whole scored
    set (reference ValidatorMDN.py:104-185, with the JAX package's global-max
    fix; `scoring.payload_to_scores("mdn")`).
  * NF — anomaly map from the flow forward; image score = max over the map
    (reference ValidatorNF.py:137-142).
  * MDN over ResNet stages — one head per stage map; per-stage probability
    maps upsampled, inverted and averaged; image score = max
    (`scoring.payload_to_scores("mdn_resnet")`).
  * NF over ResNet stages — one flow per stage map (0, 1, 2); the mean of
    the three anomaly maps, image score = max (reference
    ValidatorNF.valid_loop_resnet_nf, :152-219).
  * Reconstruction — anomaly map = the channel mean of the squared error
    between the auto-encoder's reconstruction and its preprocessed input;
    image score = max (reference ValidatorRecon.py:92-136). The VAE
    (`make_vae_batch_fn`, `score_vae`, `evaluate_vae`; JAX `train_vae`'s
    evaluation :1616-1660) the same, its reconstruction decoded from the
    posterior mean.

Every `evaluate_*` takes `figures_dir` (write the six figures of
`save_eval_figures` there; the first 9 images are kept for the overlays) and
`logger` (a `utils.logging.MetricLogger` the figures are registered with).

With `hp.mesh` the scorers shard every batch over the data axis (JAX
`_eval_mesh` :100): each data rank scores its rows and the payloads are
gathered to every rank (`parallel/multihost.fetch_global`), so the metrics
and figures use the whole set.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vit_ad_tpu_torch.config import HyperParams
from vit_ad_tpu_torch.data.loader import Batch, DataPipeline, preprocess
from vit_ad_tpu_torch.models.flow import NormalizingFlow, patch_tokens_to_map
from vit_ad_tpu_torch.models.mdn import GaussianMDN
from vit_ad_tpu_torch.models.outputs import Encoder
from vit_ad_tpu_torch.models.resnet import ResNetEncoder
from vit_ad_tpu_torch.parallel.context import MeshContext
from vit_ad_tpu_torch.parallel.multihost import fetch_global
from vit_ad_tpu_torch.pipeline import metrics as M
from vit_ad_tpu_torch.scoring import payload_to_scores


class ScoreOutput(NamedTuple):
    """Label-free scoring payload (JAX `ScoreOutput`)."""

    image_scores: np.ndarray            # [N] anomaly score per image
    pixel_scores: np.ndarray            # [N, H, W] anomaly map per image
    labels: np.ndarray                  # [N] path-inferred 0/1
    masks: np.ndarray                   # [N, H, W] ground-truth or zeros
    origs: Optional[np.ndarray] = None  # the first keep_origs uint8 images


def _as_device(a: Optional[np.ndarray], device: torch.device) -> Optional[torch.Tensor]:
    return None if a is None else torch.as_tensor(a, dtype=torch.float32, device=device)


def metrics_of(s: ScoreOutput, hp: HyperParams, figures_dir: Optional[str] = None,
               logger: Any = None, vmax: float = 1.0,
               recons: Optional[np.ndarray] = None) -> Dict[str, float]:
    """The reference metric suite of a labelled ScoreOutput, and with
    `figures_dir` its figures (JAX `_metrics_and_figures`)."""
    result = M.EvalResult(
        image_scores=s.image_scores, image_labels=s.labels.astype(np.float64),
        pixel_scores=s.pixel_scores, pixel_labels=s.masks.astype(np.float64), origs=s.origs,
        recons=recons)
    out = M.calc_all_metrics(result, hp.fp_threshold)
    if figures_dir:
        save_eval_figures(result, out, figures_dir, hp.fp_threshold, vmax=vmax, logger=logger)
    return out


def eval_figure_arrays(result: M.EvalResult, metrics: Dict[str, float],
                       fp_threshold: float = 0.3, vmax: float = 1.0) -> Dict[str, np.ndarray]:
    """The six figures of `save_eval_figures` as RGB arrays, by name."""
    from vit_ad_tpu_torch.utils import images as I

    thresholded = M.create_heatmap_from_scores(result.pixel_scores, result.pixel_labels,
                                               fp_threshold)
    n = min(9, thresholded.shape[0])
    origs = None if result.origs is None else result.origs[:n]
    if origs is not None and origs.dtype == np.uint8:
        origs = origs.astype(np.float32) / 255.0
    heat, gt, over = I.plot_heatmaps(thresholded[:n], result.pixel_labels[:n], origs, vmax=vmax,
                                     n=n)
    figures = {"heatmaps": heat, "ground_truth": gt, "overlay": over}
    if result.recons is not None:
        figures["recons"] = I.plot_recons(result.recons)
    fpr, tpr, _ = M.roc_curve(result.image_labels, result.image_scores)
    figures["roc_curve"] = I.plot_roc_curve(fpr, tpr,
                                            metrics.get("image_auroc_score", float("nan")))
    precision, recall, _ = M.precision_recall_curve(result.image_labels, result.image_scores)
    figures["pr_curve"] = I.plot_pr_curve(precision, recall,
                                          metrics.get("image_prauc_score", float("nan")))
    return figures


def save_eval_figures(result: M.EvalResult, metrics: Dict[str, float], out_dir: str,
                      fp_threshold: float = 0.3, vmax: float = 1.0,
                      logger: Any = None) -> Dict[str, str]:
    """Write the reference's eval figures into `out_dir` (reference
    ValidationHelper.py:149-153,193-209 via ImageHelper.py:66-150):

      heatmaps.png       FPR-thresholded anomaly-map grid (jet)
      ground_truth.png   mask grid
      overlay.png        thresholded map over the original images
      recons.png         reconstruction grid (recon head only)
      roc_curve.png      image-level ROC, AUROC in the title
      pr_curve.png       image-level precision-recall, PR-AUC in the title

    Each is registered with `logger` when one is given. Returns {name: path}."""
    from vit_ad_tpu_torch.utils.images import save_png

    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, image in eval_figure_arrays(result, metrics, fp_threshold, vmax).items():
        paths[name] = save_png(image, os.path.join(out_dir, f"{name}.png"))
        if logger is not None:
            logger.log_figure(name, paths[name])
    return paths


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


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _eval_mesh(hp: HyperParams, device: torch.device) -> Optional[MeshContext]:
    """The scorers' mesh from `hp.mesh` (the trainers' configuration), so
    `--mesh` shards scoring batches over the data axis too; None by
    default."""
    return MeshContext.from_hp(hp, devices=device)


def score_mdn(encoder: Encoder, mdn: GaussianMDN, test_data: DataPipeline,
              hp: HyperParams, mean: Optional[np.ndarray] = None,
              std: Optional[np.ndarray] = None, keep_origs: int = 0) -> ScoreOutput:
    """MDN scoring pipeline on the device the models live on. Scores are
    comparable within one call (global-max normalization over the set)."""
    device = _device_of(encoder)
    fn = make_mdn_batch_fn(encoder, mdn, hp, _as_device(mean, device), _as_device(std, device))
    ll, labels, masks, origs = _collect(test_data.test_batches(hp.prefetch), fn, device,
                                        keep_origs, _eval_mesh(hp, device))
    image_scores, pixel_scores = payload_to_scores("mdn", ll, hp.img_size)
    return ScoreOutput(image_scores, pixel_scores, labels, masks, origs)


def evaluate_mdn(encoder: Encoder, mdn: GaussianMDN, test_data: DataPipeline,
                 hp: HyperParams, mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None, figures_dir: Optional[str] = None,
                 logger: Any = None) -> Dict[str, float]:
    """score_mdn + the reference metric suite (+ figures)."""
    s = score_mdn(encoder, mdn, test_data, hp, mean, std, keep_origs=9 if figures_dir else 0)
    return metrics_of(s, hp, figures_dir, logger)


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
             device: torch.device, keep_origs: int = 0, mc: Optional[MeshContext] = None):
    """Score every batch; return (payloads, labels, masks, origs) with the
    padded rows trimmed; origs are the first `keep_origs` uint8 images (None
    for 0). A `score_fn` that returns a tuple (one output per stage) gives a
    tuple of concatenated payloads. With a mesh each data rank scores its
    rows of every batch and the payloads are gathered to every rank."""
    payloads, labels, masks, origs = [], [], [], []
    per_stage = False
    kept = 0
    for batch in batches:
        n = int(batch.valid.sum())
        images = batch.images if mc is None else mc.shard_batch(batch.images)
        with torch.inference_mode():
            out = score_fn(torch.from_numpy(images).to(device))
            per_stage = isinstance(out, tuple)
            payloads.append([fetch_global(o.float(), mc)[:n]
                             for o in (out if per_stage else (out,))])
        labels.append(batch.labels[:n])
        masks.append(batch.masks[:n])
        if kept < keep_origs:
            origs.append(batch.images[:min(n, keep_origs - kept)])
            kept += len(origs[-1])
    if not payloads:
        raise ValueError("no batches to score")
    cat = tuple(np.concatenate(stage) for stage in zip(*payloads))
    return (cat if per_stage else cat[0], np.concatenate(labels), np.concatenate(masks),
            np.concatenate(origs) if origs else None)


def score_nf(encoder: Encoder, flow: NormalizingFlow, test_data: DataPipeline,
             hp: HyperParams, mean: Optional[np.ndarray] = None,
             std: Optional[np.ndarray] = None, keep_origs: int = 0) -> ScoreOutput:
    """NF scoring pipeline on the device the models live on."""
    device = _device_of(encoder)
    anomaly_maps = make_nf_batch_fn(encoder, flow, hp, _as_device(mean, device),
                                    _as_device(std, device))
    maps, labels, masks, origs = _collect(test_data.test_batches(hp.prefetch), anomaly_maps,
                                          device, keep_origs, _eval_mesh(hp, device))
    image_scores, maps = payload_to_scores("nf", maps, hp.img_size)
    return ScoreOutput(image_scores, maps, labels, masks, origs)


def evaluate_nf(encoder: Encoder, flow: NormalizingFlow, test_data: DataPipeline,
                hp: HyperParams, mean: Optional[np.ndarray] = None,
                std: Optional[np.ndarray] = None, figures_dir: Optional[str] = None,
                logger: Any = None) -> Dict[str, float]:
    """score_nf + the reference metric suite (+ figures)."""
    s = score_nf(encoder, flow, test_data, hp, mean, std, keep_origs=9 if figures_dir else 0)
    return metrics_of(s, hp, figures_dir, logger)


def resnet_stage_tokens(encoder: ResNetEncoder, images_u8: torch.Tensor,
                        mean: Optional[torch.Tensor], std: Optional[torch.Tensor],
                        stages: Sequence[int]) -> List[torch.Tensor]:
    """uint8 images → the LayerNorm'd maps of `stages` as tokens [B, h*w, C]
    (the trunk without gradient, the stage norms with)."""
    return [m.flatten(1, 2) for m in resnet_stage_maps(encoder, images_u8, mean, std, stages)]


def resnet_stage_maps(encoder: ResNetEncoder, images_u8: torch.Tensor,
                      mean: Optional[torch.Tensor], std: Optional[torch.Tensor],
                      stages: Sequence[int]) -> List[torch.Tensor]:
    """uint8 images → the LayerNorm'd maps [B, h, w, C] of `stages`."""
    return encoder.stage_features(preprocess(images_u8, mean, std), stages)


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
                     stages: Sequence[int] = (2, 3), keep_origs: int = 0) -> ScoreOutput:
    """Multi-stage MDN scoring (reference ValidatorMdn.valid_loop_resnet):
    per-stage probability maps are upsampled (align_corners=True), inverted
    to anomaly and averaged. As in the JAX package, and unlike the reference:
    probabilities are normalized by the max over the whole scored set, not
    per batch, and the image score is the max over the averaged anomaly map
    (the reference takes min-then-reinvert, a double inversion)."""
    device = _device_of(encoder)
    fn = make_mdn_resnet_batch_fn(encoder, mdns, hp, _as_device(mean, device),
                                  _as_device(std, device), stages)
    stage_lls, labels, masks, origs = _collect(test_data.test_batches(hp.prefetch), fn, device,
                                               keep_origs, _eval_mesh(hp, device))
    image_scores, pixel_scores = payload_to_scores("mdn_resnet", stage_lls, hp.img_size)
    return ScoreOutput(image_scores, pixel_scores, labels, masks, origs)


def evaluate_mdn_resnet(encoder: ResNetEncoder, mdns: Sequence[GaussianMDN],
                        test_data: DataPipeline, hp: HyperParams,
                        mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None,
                        stages: Sequence[int] = (2, 3), figures_dir: Optional[str] = None,
                        logger: Any = None) -> Dict[str, float]:
    """score_mdn_resnet + the reference metric suite (+ figures)."""
    s = score_mdn_resnet(encoder, mdns, test_data, hp, mean, std, stages,
                         keep_origs=9 if figures_dir else 0)
    return metrics_of(s, hp, figures_dir, logger)


def make_nf_resnet_batch_fn(encoder: ResNetEncoder, flows: Sequence[NormalizingFlow],
                            hp: HyperParams, mean: Optional[torch.Tensor],
                            std: Optional[torch.Tensor], stages: Sequence[int] = (0, 1, 2)
                            ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Per-batch multi-stage NF scorer: uint8 images [B, H, W, 3] on the
    models' device → the mean of the stages' anomaly maps [B, H, W] f32 (the
    device half of `score_nf_resnet`). No kernel of the repo runs here: the
    trunk, the stage norms and the flows are torch ops."""

    def anomaly_maps(images_u8: torch.Tensor) -> torch.Tensor:
        maps = resnet_stage_maps(encoder, images_u8, mean, std, stages)
        return torch.mean(torch.stack([flow(m).anomaly_score_map
                                       for m, flow in zip(maps, flows)], -1), dim=-1)

    return anomaly_maps


def score_nf_resnet(encoder: ResNetEncoder, flows: Sequence[NormalizingFlow],
                    test_data: DataPipeline, hp: HyperParams,
                    mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None,
                    stages: Sequence[int] = (0, 1, 2), keep_origs: int = 0) -> ScoreOutput:
    """Multi-stage NF scoring (reference ValidatorNF.valid_loop_resnet_nf,
    :152-219): the mean of the stage anomaly maps, image score = max
    (:183-199)."""
    device = _device_of(encoder)
    fn = make_nf_resnet_batch_fn(encoder, flows, hp, _as_device(mean, device),
                                 _as_device(std, device), stages)
    maps, labels, masks, origs = _collect(test_data.test_batches(hp.prefetch), fn, device,
                                          keep_origs, _eval_mesh(hp, device))
    image_scores, maps = payload_to_scores("nf_resnet", maps, hp.img_size)
    return ScoreOutput(image_scores, maps, labels, masks, origs)


def evaluate_nf_resnet(encoder: ResNetEncoder, flows: Sequence[NormalizingFlow],
                       test_data: DataPipeline, hp: HyperParams,
                       mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None,
                       stages: Sequence[int] = (0, 1, 2), figures_dir: Optional[str] = None,
                       logger: Any = None) -> Dict[str, float]:
    """score_nf_resnet + the reference metric suite (+ figures)."""
    s = score_nf_resnet(encoder, flows, test_data, hp, mean, std, stages,
                        keep_origs=9 if figures_dir else 0)
    return metrics_of(s, hp, figures_dir, logger)


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
                mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None,
                keep_origs: int = 0, make_batch_fn=make_recon_batch_fn) -> ScoreOutput:
    """Reconstruction scoring on the device the model lives on: the error
    maps of `make_batch_fn(model, mean, std)` (the VAE's: `score_vae`), image
    score = max."""
    device = _device_of(model)
    fn = make_batch_fn(model, _as_device(mean, device), _as_device(std, device))
    maps, labels, masks, origs = _collect(test_data.test_batches(hp.prefetch), fn, device,
                                          keep_origs, _eval_mesh(hp, device))
    image_scores, maps = payload_to_scores("recon", maps, hp.img_size)
    return ScoreOutput(image_scores, maps, labels, masks, origs)


def evaluate_recon(model: torch.nn.Module, test_data: DataPipeline, hp: HyperParams,
                   mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None,
                   figures_dir: Optional[str] = None, logger: Any = None) -> Dict[str, float]:
    """score_recon + the reference metric suite (+ figures: the recon grid of
    the kept images, the maps at the reference's vmax=0.15,
    ValidatorRecon.py:60-90)."""
    s = score_recon(model, test_data, hp, mean, std, keep_origs=9 if figures_dir else 0)
    recons = None
    if figures_dir and s.origs is not None:
        device = _device_of(model)
        with torch.inference_mode():
            x = preprocess(torch.from_numpy(s.origs).to(device), _as_device(mean, device),
                           _as_device(std, device))
            recons = model(x).reconstruction.float().cpu().numpy()
    return metrics_of(s, hp, figures_dir, logger, vmax=0.15, recons=recons)


def make_vae_batch_fn(model: torch.nn.Module, mean: Optional[torch.Tensor],
                      std: Optional[torch.Tensor]) -> Callable[[torch.Tensor], torch.Tensor]:
    """Per-batch VAE scorer: uint8 images [B, H, W, 3] on the model's device →
    the channel-mean squared error [B, H, W] f32 of the reconstruction decoded
    from the posterior mean, a deterministic forward (JAX `train_vae`'s
    `eval_maps` :1621-1633). The model must be in eval mode."""

    def error_maps(images_u8: torch.Tensor) -> torch.Tensor:
        if model.training:
            raise ValueError("VAE scoring: the model must be in eval mode")
        x = preprocess(images_u8, mean, std)
        recon = model.decode(model.encode(x)[0])
        return torch.mean(torch.square(recon.float() - x.float()), dim=-1)

    return error_maps


def score_vae(model: torch.nn.Module, test_data: DataPipeline, hp: HyperParams,
              mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None,
              keep_origs: int = 0) -> ScoreOutput:
    """VAE scoring on the device the model lives on; image score = max of
    the error map."""
    return score_recon(model, test_data, hp, mean, std, keep_origs, make_vae_batch_fn)


def evaluate_vae(model: torch.nn.Module, test_data: DataPipeline, hp: HyperParams,
                 mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None,
                 figures_dir: Optional[str] = None, logger: Any = None) -> Dict[str, float]:
    """score_vae + the reference metric suite (+ figures, the maps at the
    recon head's vmax=0.15, as the JAX evaluation draws them)."""
    s = score_vae(model, test_data, hp, mean, std, keep_origs=9 if figures_dir else 0)
    return metrics_of(s, hp, figures_dir, logger, vmax=0.15)
