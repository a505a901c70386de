"""Anomaly-detection metrics engine (port of `vit_ad_tpu/pipeline/metrics.py`:
the same numpy code; `np.trapz` stands in for `np.trapezoid` on numpy < 2).

Re-implements the reference's sklearn-based metric suite
(reference src/util/ValidationHelper.py:42-211) as vectorized NumPy with the
same outputs and metric names (`image_auroc_score`, `pixel_auroc_score`,
`image_prauc_score`, `pro_score_{fp}fp`), golden-tested against sklearn in
tests/test_metrics.py. Scores arrive as device arrays; everything here is a
single device→host transfer followed by O(n log n) host work — the sklearn
dependency becomes optional.

Semantics preserved:
  * ROC curve / AUROC per sklearn.roc_curve (distinct-score thresholds,
    trapezoid AUC).
  * PR-AUC as trapezoid over the sklearn precision_recall_curve — the
    reference uses metrics.auc(recall, precision) (ValidationHelper.py:180-183),
    NOT average precision.
  * calc_threshold: the largest-TPR threshold with FPR <= fp_threshold
    (Mishra-style, ValidationHelper.py:70-87; fpr is nondecreasing so this is
    the last curve point with fpr <= cap).
  * "PRO" score: AUROC of the *thresholded* ("fluently" zeroed below
    threshold) pixel map vs pixel labels (ValidationHelper.py:149-178).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _as_1d_float(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64).ravel()


def _binary_curve_counts(
    labels: np.ndarray, scores: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cumulative TP/FP counts at each distinct score threshold (descending),
    matching sklearn's _binary_clf_curve."""
    order = np.argsort(-scores, kind="stable")
    scores = scores[order]
    labels = labels[order]
    # indices of last occurrence of each distinct score
    distinct = np.where(np.diff(scores))[0]
    threshold_idxs = np.r_[distinct, labels.size - 1]
    tps = np.cumsum(labels)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    return fps, tps, scores[threshold_idxs]


def roc_curve(
    labels, scores
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds), sklearn-compatible incl. the leading
    (0,0, inf) point."""
    labels = _as_1d_float(labels)
    scores = _as_1d_float(scores)
    fps, tps, thresh = _binary_curve_counts(labels, scores)
    # drop collinear points like sklearn (optimal for AUC it's harmless to keep;
    # keep all for simplicity — AUC identical)
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresh = np.r_[np.inf, thresh]
    if fps[-1] <= 0 or tps[-1] <= 0:
        raise ValueError("roc_curve needs both classes present")
    return fps / fps[-1], tps / tps[-1], thresh


def roc_auc_score(labels, scores) -> float:
    fpr, tpr, _ = roc_curve(labels, scores)
    return float(_trapezoid(tpr, fpr))


def precision_recall_curve(
    labels, scores
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """sklearn-compatible PR curve (reversed order, final (1,0) point)."""
    labels = _as_1d_float(labels)
    scores = _as_1d_float(scores)
    fps, tps, thresh = _binary_curve_counts(labels, scores)
    denom = tps + fps
    precision = np.divide(tps, denom, out=np.zeros_like(tps, dtype=np.float64),
                          where=denom > 0)
    recall = tps / tps[-1]
    # sklearn cuts after full recall is first reached and reverses
    last = tps.searchsorted(tps[-1])
    sl = slice(last, None, -1)
    return (
        np.r_[precision[sl], 1.0],
        np.r_[recall[sl], 0.0],
        thresh[sl],
    )


def prauc_score(labels, scores) -> float:
    """Trapezoid AUC over the PR curve — parity with reference
    metrics.auc(x=recall, y=precision) (ValidationHelper.py:180-183)."""
    precision, recall, _ = precision_recall_curve(labels, scores)
    # recall is decreasing → integrate reversed
    return float(_trapezoid(precision[::-1], recall[::-1]))


def calc_threshold(anomaly_map, labels, fp_threshold: float = 0.3) -> float:
    """Largest-TPR threshold subject to FPR <= fp_threshold
    (reference ValidationHelper.py:70-87)."""
    fpr, tpr, thresholds = roc_curve(labels, anomaly_map)
    idx = np.where(fpr <= fp_threshold)[0]
    j = idx[np.argmax(tpr[idx])]
    return float(thresholds[j])


def predict_anomaly(
    anomaly_map: np.ndarray, threshold: float, classification_type: str = "binary"
) -> np.ndarray:
    """Thresholded prediction (reference ValidationHelper.py:90-102)."""
    if classification_type == "binary":
        return np.where(anomaly_map > threshold, 1, 0)
    return np.where(anomaly_map > threshold, anomaly_map, 0)


def create_heatmap_from_scores(
    anomaly_map: np.ndarray, pixel_labels: np.ndarray, fp_threshold: float
) -> np.ndarray:
    """Zero the anomaly map below the FPR-capped threshold
    (reference ValidationHelper.py:105-128)."""
    threshold = calc_threshold(
        anomaly_map.ravel(), pixel_labels.ravel(), fp_threshold
    )
    return predict_anomaly(anomaly_map, threshold, "fluently")


def aupro_score(
    pixel_labels,
    pixel_scores,
    fpr_limit: float = 0.3,
    max_steps: int = 50_000,
) -> float:
    """TRUE per-region-overlap AUPRO (the standard MVTec AD protocol).

    The reference's `pro_score_{fp}fp` is NOT this metric — it is the AUROC
    of the FPR-thresholded pixel map (reference ValidationHelper.py:149-178),
    kept verbatim for result-table parity. This is the real thing, emitted
    additionally: for every distinct score threshold, PRO(t) = mean over all
    connected ground-truth regions of the fraction of the region's pixels
    predicted anomalous, FPR(t) = fraction of good pixels predicted
    anomalous; the PRO-vs-FPR curve is integrated from 0 to `fpr_limit` and
    normalized by the limit.

    Exact for inputs with <= `max_steps` distinct score values (the curve is
    evaluated at every distinct score with FPR <= limit); above that the
    threshold grid is evenly subsampled (endpoints kept), a standard
    approximation. Regions use 4-connectivity (scipy.ndimage.label default,
    same as MVTec's official evaluation code).
    """
    labels = np.asarray(pixel_labels)
    scores = np.asarray(pixel_scores, dtype=np.float64)
    if labels.ndim == 2:
        labels, scores = labels[None], scores[None]
    labels = labels.reshape(-1, *labels.shape[-2:])
    scores = scores.reshape(labels.shape)

    from scipy import ndimage

    regions = []  # per ground-truth region: its pixels' scores, sorted
    for lab, sc in zip(labels, scores):
        comp, n = ndimage.label(lab != 0)
        for r in range(1, n + 1):
            regions.append(np.sort(sc[comp == r], kind="stable"))
    if not regions:
        raise ValueError("aupro_score needs at least one anomalous region")
    neg = np.sort(scores[labels == 0].ravel(), kind="stable")
    if neg.size == 0:
        raise ValueError("aupro_score needs good (negative) pixels")

    ts = np.unique(scores)  # ascending
    fpr_all = (neg.size - np.searchsorted(neg, ts, side="left")) / neg.size
    keep = fpr_all <= fpr_limit  # fpr decreases with t → a suffix of ts
    if not np.any(keep):
        return 0.0
    lo = max(int(np.argmax(keep)) - 1, 0)  # one extra point brackets the limit
    ts, fpr = ts[lo:], fpr_all[lo:]
    if ts.size > max_steps:
        idx = np.unique(np.linspace(0, ts.size - 1, max_steps).astype(int))
        ts, fpr = ts[idx], fpr[idx]

    pro = np.zeros(ts.size)
    for sr in regions:
        pro += (sr.size - np.searchsorted(sr, ts, side="left")) / sr.size
    pro /= len(regions)

    fpr, pro = fpr[::-1], pro[::-1]  # ascending fpr
    if fpr[-1] > fpr_limit:
        j = int(np.searchsorted(fpr, fpr_limit, side="left"))
        # fpr[j-1] <= limit < fpr[j]: interpolate the crossing
        w = (fpr_limit - fpr[j - 1]) / (fpr[j] - fpr[j - 1])
        fpr = np.r_[fpr[:j], fpr_limit]
        pro = np.r_[pro[:j], pro[j - 1] + w * (pro[j] - pro[j - 1])]
    if fpr[0] > 0.0:
        # anchor at the empty prediction set
        fpr, pro = np.r_[0.0, fpr], np.r_[0.0, pro]
    return float(_trapezoid(pro, fpr) / fpr_limit)


@dataclass
class EvalResult:
    """Container mirroring the reference's ValidLoopReturn TypedDict
    (ValidationHelper.py:30-39)."""

    image_scores: np.ndarray        # [N]
    image_labels: np.ndarray        # [N]
    pixel_scores: np.ndarray        # [N, H, W]
    pixel_labels: np.ndarray        # [N, H, W]
    origs: Optional[np.ndarray] = None
    recons: Optional[np.ndarray] = None
    extras: Dict[str, np.ndarray] = field(default_factory=dict)


def calc_all_metrics(
    result: EvalResult, fp_threshold: float = 0.3
) -> Dict[str, float]:
    """Image AUROC / pixel AUROC / image PR-AUC / thresholded-PRO metric set
    with the reference's metric names (ValidationHelper.py:193-209)."""
    anomalies = create_heatmap_from_scores(
        result.pixel_scores, result.pixel_labels, fp_threshold
    )
    out = {
        "image_auroc_score": roc_auc_score(result.image_labels, result.image_scores),
        "pixel_auroc_score": roc_auc_score(
            result.pixel_labels.ravel(), result.pixel_scores.ravel()
        ),
        "image_prauc_score": prauc_score(result.image_labels, result.image_scores),
        f"pro_score_{fp_threshold}fp": roc_auc_score(
            result.pixel_labels.ravel(), anomalies.ravel()
        ),
        # the STANDARD per-region-overlap AUPRO, additional to the
        # reference's "pro" (which is a thresholded-map AUROC — see
        # aupro_score's docstring)
        f"aupro_score_{fp_threshold}fp": aupro_score(
            result.pixel_labels, result.pixel_scores, fpr_limit=fp_threshold
        ),
        "fp_thres": fp_threshold,
    }
    return out
