"""Per-item dataset honoring the MVTec/BTAD directory contract (port of
`vit_ad_tpu/data/dataset.py`).

Label/mask rules match reference GeneralDataset.__getitem__
(src/data_loader/GeneralDataset.py:61-117): a directory ending in "good" or
"ok" is label 0 with a zero mask; "ko" (BTAD) and everything else (MVTec
defects) is label 1 with its mask under /ground_truth/. Host work is decode +
resize only: the native C++ decoder (`data/native.py`, the JAX package's
`native/dataio.cpp`, PIL's triangle filter) where it builds, else PIL
bilinear, as the JAX package decodes (its dataset.py:78-100); a file the
native decoder rejects goes through PIL, so an unreadable one raises PIL's
error. Scaling and normalization run on the device (`data/loader.preprocess`).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

from vit_ad_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from vit_ad_tpu_torch.data import native


# what decoding an unreadable or half-written image file raises: PIL's
# `UnidentifiedImageError` and "image file is truncated" are both OSErrors
DECODE_ERRORS = (OSError,)


def load_image(path: str, img_size: int) -> np.ndarray:
    """Decode + bilinear resize → uint8 [img_size, img_size, 3], natively
    where the library is built, else (and for a file it rejects) through PIL;
    raises one of `DECODE_ERRORS` for a file that is not a whole image."""
    img = native.load_image(path, img_size)
    if img is not None:
        return img
    with Image.open(path) as im:
        img = im.convert("RGB").resize((img_size, img_size), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def infer_label(image_path: str) -> int:
    d = os.path.dirname(image_path)
    return 0 if (d.endswith("good") or d.endswith("ok")) else 1


def mask_path_for(image_path: str) -> Optional[str]:
    """Ground-truth mask path per the reference's path-rewrite rules, or None
    for good/ok samples."""
    d = os.path.dirname(image_path)
    if d.endswith("good") or d.endswith("ok"):
        return None
    gt = image_path.replace(f"{os.sep}test{os.sep}", f"{os.sep}ground_truth{os.sep}")
    if d.endswith("ko"):  # BTAD: .bmp → .png except category "03"
        return gt if f"{os.sep}03{os.sep}" in image_path else gt.replace(".bmp", ".png")
    return gt.replace(".png", "_mask.png").replace(".bmp", ".png")  # MVTec


class AnomalyDataset:
    """Index-addressable dataset yielding uint8 [H, W, 3] images (+ uint8
    masks and int labels in validation mode)."""

    def __init__(self, file_names: List[str], img_size: int, validation: bool = False,
                 missing_mask_ok: bool = False) -> None:
        self.file_names = file_names
        self.img_size = img_size
        self.validation = validation
        # label-free folder scoring: a missing mask means zeros; labeled
        # layouts keep the loud FileNotFoundError
        self.missing_mask_ok = missing_mask_ok

    def __len__(self) -> int:
        return len(self.file_names)

    def _load_image(self, path: str) -> np.ndarray:
        return load_image(path, self.img_size)

    def _load_mask(self, image_path: str) -> np.ndarray:
        mp = mask_path_for(image_path)
        if mp is None or (self.missing_mask_ok and not os.path.exists(mp)):
            return np.zeros((self.img_size, self.img_size), dtype=np.uint8)
        mask = native.load_mask(mp, self.img_size)
        if mask is not None:
            return mask
        with Image.open(mp) as im:
            mask = np.asarray(im.resize((self.img_size, self.img_size), Image.BILINEAR))
        if mask.ndim == 3:
            mask = mask[..., 0]
        return (mask != 0).astype(np.uint8)  # binarize (reference :102,:112)

    def __getitem__(self, index: int):
        path = self.file_names[index]
        image = self._load_image(path)
        if not self.validation:
            return image
        return image, self._load_mask(path), infer_label(path)


def default_norm_stats() -> Tuple[np.ndarray, np.ndarray]:
    return np.asarray(IMAGENET_MEAN, np.float32), np.asarray(IMAGENET_STD, np.float32)
