"""Figures of the evaluators and trainers (port of `vit_ad_tpu/utils/images.py`:
`plot_recons` :56, `plot_heatmaps` :74, `plot_loss_curves` :113,
`plot_roc_curve` :127, `plot_pr_curve` :143, `plot_dataset_distribution`
:159), drawn with numpy and PIL.

Every figure is an RGB uint8 array [H, W, 3]: the maps and overlays through a
256-entry jet table (matplotlib's "jet", segment for segment), grids as tiled
arrays on a white ground, curves as polylines through `PIL.ImageDraw` with the
AUROC or PR-AUC in the title. `save_png` writes one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw

# matplotlib's jet: (x, value) knots of each channel's piecewise-linear map
_JET_KNOTS = (
    ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
    ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0), (0.91, 0.0), (1.0, 0.0)),
    ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0)),
)
_X = np.linspace(0.0, 1.0, 256)
# [256, 3] uint8, truncated as matplotlib's `Colormap(x, bytes=True)` does
JET = (np.stack([np.interp(_X, *zip(*knots)) for knots in _JET_KNOTS], -1) * 255
       ).astype(np.uint8)

_GAP = 2
_WHITE = (255, 255, 255)
_CURVE = ((31, 119, 180), (255, 127, 14))  # the first two of matplotlib's cycle


def colorize(values: np.ndarray, vmin: float = 0.0, vmax: float = 1.0) -> np.ndarray:
    """values [...] → jet RGB [..., 3] uint8 over [vmin, vmax] (outside it:
    the end colours)."""
    x = (np.asarray(values, np.float64) - vmin) / ((vmax - vmin) or 1.0)
    return JET[np.clip(np.floor(x * 256), 0, 255).astype(np.int64)]


def to_rgb8(image: np.ndarray) -> np.ndarray:
    """An image in [0, 1] (float) or uint8, gray [H, W] or RGB [H, W, 3] →
    RGB uint8."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img


def overlay(image: np.ndarray, values: np.ndarray, vmin: float = 0.0, vmax: float = 1.0,
            alpha: float = 0.4) -> np.ndarray:
    """The jet map of `values` over `image` (RGB [H, W, 3]) with `alpha`."""
    base = to_rgb8(image).astype(np.float64)
    blend = (1.0 - alpha) * base + alpha * colorize(values, vmin, vmax)
    return (blend + 0.5).astype(np.uint8)


def grid(tiles: Sequence[np.ndarray], n: int = 9) -> np.ndarray:
    """The first n RGB tiles (one size) on a ceil(√n)-square grid."""
    n = min(n, len(tiles))
    side = int(np.ceil(np.sqrt(n)))
    h, w = tiles[0].shape[:2]
    out = np.full((side * (h + _GAP) - _GAP, side * (w + _GAP) - _GAP, 3), 255, np.uint8)
    for i in range(n):
        r, c = divmod(i, side)
        out[r * (h + _GAP):r * (h + _GAP) + h, c * (w + _GAP):c * (w + _GAP) + w] = tiles[i]
    return out


def plot_heatmaps(anomaly_maps: np.ndarray, ground_truth: np.ndarray,
                  originals: Optional[np.ndarray] = None, vmin: float = 0.0,
                  vmax: float = 1.0, n: int = 9) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(heatmaps, ground truth, overlay) grids: the maps through jet, the
    masks in gray, the maps over the originals (over black without them)."""
    n = min(n, anomaly_maps.shape[0])
    heat = grid([colorize(anomaly_maps[i], vmin, vmax) for i in range(n)], n)
    gt = grid([to_rgb8(np.asarray(ground_truth[i], np.float64)) for i in range(n)], n)
    base = (originals if originals is not None
            else np.zeros(anomaly_maps.shape[:3] + (3,), np.uint8))
    over = grid([overlay(base[i], anomaly_maps[i], vmin, vmax) for i in range(n)], n)
    return heat, gt, over


def plot_recons(recons: np.ndarray, n: int = 9) -> np.ndarray:
    """Grid of reconstructions [N, H, W, 3] in [-1, 1] or [0, 1]."""
    tiles = []
    for img in recons[:n]:
        img = np.asarray(img, np.float64)
        tiles.append(to_rgb8((img + 1.0) / 2.0 if img.min() < 0 else img))
    return grid(tiles, n)


def _plot(series: List[Tuple[np.ndarray, np.ndarray, str]], title: str, xlabel: str,
          ylabel: str, diagonal: bool = False, size: int = 400) -> np.ndarray:
    """Polylines of (x, y, label) on one set of axes, with a title and
    axis labels; the axes span the data."""
    im = Image.new("RGB", (size, size), _WHITE)
    d = ImageDraw.Draw(im)
    left, top, right, bottom = 50, 30, size - 15, size - 40
    xs = np.concatenate([np.asarray(s[0], np.float64) for s in series])
    ys = np.concatenate([np.asarray(s[1], np.float64) for s in series])
    finite = np.isfinite(xs) & np.isfinite(ys)
    x0, x1 = (float(xs[finite].min()), float(xs[finite].max())) if finite.any() else (0.0, 1.0)
    y0, y1 = (float(ys[finite].min()), float(ys[finite].max())) if finite.any() else (0.0, 1.0)
    if diagonal:
        x0, x1, y0, y1 = min(x0, 0.0), max(x1, 1.0), min(y0, 0.0), max(y1, 1.0)
    sx, sy = (right - left) / ((x1 - x0) or 1.0), (bottom - top) / ((y1 - y0) or 1.0)
    px = lambda x, y: (left + (x - x0) * sx, bottom - (y - y0) * sy)
    d.rectangle((left, top, right, bottom), outline=(0, 0, 0))
    if diagonal:
        d.line([px(0.0, 0.0), px(1.0, 1.0)], fill=(128, 128, 128))
    for k, (x, y, label) in enumerate(series):
        keep = np.isfinite(x) & np.isfinite(y)
        pts = [px(a, b) for a, b in zip(np.asarray(x)[keep], np.asarray(y)[keep])]
        color = _CURVE[k % len(_CURVE)]
        if len(pts) > 1:
            d.line(pts, fill=color, width=2)
        d.text((left + 8, top + 8 + 14 * k), label, fill=color)
    d.text((left, 8), title, fill=(0, 0, 0))
    d.text(((left + right) // 2 - 3 * len(xlabel), bottom + 20), xlabel, fill=(0, 0, 0))
    d.text((4, top - 14), ylabel, fill=(0, 0, 0))
    for v, (a, b) in ((x0, px(x0, y0)), (x1, px(x1, y0))):
        d.text((a - 8, b + 4), f"{v:.3g}", fill=(0, 0, 0))
    for v, (a, b) in ((y0, px(x0, y0)), (y1, px(x0, y1))):
        d.text((4, b - 6), f"{v:.3g}", fill=(0, 0, 0))
    return np.asarray(im)


def plot_roc_curve(fpr: np.ndarray, tpr: np.ndarray, auc: float,
                   title: str = "ROC") -> np.ndarray:
    return _plot([(fpr, tpr, f"AUC = {auc:.4f}")], f"{title}  AUROC = {auc:.4f}",
                 "false positive rate", "true positive rate", diagonal=True)


def plot_pr_curve(precision: np.ndarray, recall: np.ndarray, auc: float,
                  title: str = "precision-recall") -> np.ndarray:
    return _plot([(recall, precision, f"PR-AUC = {auc:.4f}")], f"{title}  PRAUC = {auc:.4f}",
                 "recall", "precision")


def plot_loss_curves(history: Dict[str, List[float]]) -> np.ndarray:
    """Train and validation loss per epoch."""
    series = [(np.arange(len(history[k]), dtype=np.float64),
               np.asarray(history[k], np.float64), k)
              for k in ("train_loss", "valid_loss") if k in history]
    return _plot(series, "loss", "epoch", "loss")


def plot_dataset_distribution(counts: Dict[str, int],
                              title: str = "dataset distribution") -> np.ndarray:
    """Bars of the images per class (JAX `plot_dataset_distribution`;
    reference ImageHelper.py:225-306), each labelled with its class and
    count."""
    width = max(400, 40 * len(counts) + 60)
    im = Image.new("RGB", (width, 300), _WHITE)
    d = ImageDraw.Draw(im)
    left, top, right, bottom = 40, 30, width - 15, 260
    d.rectangle((left, top, right, bottom), outline=(0, 0, 0))
    d.text((left, 8), title, fill=(0, 0, 0))
    peak = max(counts.values(), default=0) or 1
    slot = (right - left) / max(len(counts), 1)
    for i, (name, n) in enumerate(counts.items()):
        x0 = left + i * slot + slot * 0.15
        x1 = left + (i + 1) * slot - slot * 0.15
        d.rectangle((x0, bottom - (bottom - top - 14) * n / peak, x1, bottom), fill=_CURVE[0])
        d.text((x0, bottom + 4), str(name)[:8], fill=(0, 0, 0))
        d.text((x0, bottom - (bottom - top - 14) * n / peak - 12), str(n), fill=(0, 0, 0))
    return np.asarray(im)


def save_png(image: np.ndarray, path: str) -> str:
    Image.fromarray(np.asarray(image, np.uint8)).save(path)
    return path
