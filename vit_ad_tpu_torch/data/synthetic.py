"""Synthetic dataset fixtures mirroring the MVTec / BTAD directory contracts
(port of `vit_ad_tpu/data/synthetic.py`: the same numpy + PIL code, so one
seed gives the same images in both packages).

Used by tests and benchmarks since no real dataset ships with the repo. The
layouts follow the reference's expectations (reference
startTraining_recon.py:14-23, src/data_loader/GeneralDataset.py:88-113):

MVTec:  <root>/<category>/train/good/*.png
        <root>/<category>/test/good/*.png
        <root>/<category>/test/<defect>/*.png
        <root>/<category>/ground_truth/<defect>/*_mask.png
BTAD:   <root>/<category>/train/ok/*.bmp
        <root>/<category>/test/ok/*.bmp
        <root>/<category>/test/ko/*.bmp
        <root>/<category>/ground_truth/ko/*.png
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image


def _texture(rng: np.random.Generator, size: int) -> np.ndarray:
    """Smooth random texture — a plausible 'good' sample."""
    low = rng.uniform(80, 160, size=(size // 8, size // 8, 3))
    img = np.asarray(
        Image.fromarray(low.astype(np.uint8)).resize((size, size), Image.BILINEAR)
    )
    noise = rng.normal(0, 8, size=img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def _add_defect(
    img: np.ndarray, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """Paint a bright blob defect; return (defect image, binary mask)."""
    size = img.shape[0]
    mask = np.zeros((size, size), dtype=np.uint8)
    cy, cx = rng.integers(size // 4, 3 * size // 4, size=2)
    r = int(rng.integers(max(2, size // 10), max(3, size // 5)))
    yy, xx = np.mgrid[:size, :size]
    blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    mask[blob] = 255
    out = img.copy()
    out[blob] = np.clip(out[blob].astype(np.int32) + 90, 0, 255).astype(np.uint8)
    return out, mask


def make_mvtec_category(
    root: str,
    category: str = "synthcat",
    img_size: int = 64,
    n_train: int = 20,
    n_test_good: int = 5,
    n_test_defect: int = 5,
    seed: int = 0,
) -> str:
    """Create one MVTec-layout category; returns its directory."""
    rng = np.random.default_rng(seed)
    cat = os.path.join(root, category)
    for sub in ("train/good", "test/good", "test/crack", "ground_truth/crack"):
        os.makedirs(os.path.join(cat, sub), exist_ok=True)
    for i in range(n_train):
        Image.fromarray(_texture(rng, img_size)).save(
            os.path.join(cat, "train/good", f"{i:03d}.png")
        )
    for i in range(n_test_good):
        Image.fromarray(_texture(rng, img_size)).save(
            os.path.join(cat, "test/good", f"{i:03d}.png")
        )
    for i in range(n_test_defect):
        img, mask = _add_defect(_texture(rng, img_size), rng)
        Image.fromarray(img).save(os.path.join(cat, "test/crack", f"{i:03d}.png"))
        Image.fromarray(mask).save(
            os.path.join(cat, "ground_truth/crack", f"{i:03d}_mask.png")
        )
    return cat


def make_btad_category(
    root: str,
    category: str = "01",
    img_size: int = 64,
    n_train: int = 12,
    n_test_ok: int = 4,
    n_test_ko: int = 4,
    seed: int = 1,
) -> str:
    """Create one BTAD-layout category (bmp images, ko masks as png)."""
    rng = np.random.default_rng(seed)
    cat = os.path.join(root, category)
    for sub in ("train/ok", "test/ok", "test/ko", "ground_truth/ko"):
        os.makedirs(os.path.join(cat, sub), exist_ok=True)
    for i in range(n_train):
        Image.fromarray(_texture(rng, img_size)).save(
            os.path.join(cat, "train/ok", f"{i:03d}.bmp")
        )
    for i in range(n_test_ok):
        Image.fromarray(_texture(rng, img_size)).save(
            os.path.join(cat, "test/ok", f"{i:03d}.bmp")
        )
    for i in range(n_test_ko):
        img, mask = _add_defect(_texture(rng, img_size), rng)
        Image.fromarray(img).save(os.path.join(cat, "test/ko", f"{i:03d}.bmp"))
        Image.fromarray(mask).save(
            os.path.join(cat, "ground_truth/ko", f"{i:03d}.png")
        )
    return cat
