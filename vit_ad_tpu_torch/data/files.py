"""File discovery and deterministic splits (port of `vit_ad_tpu/data/files.py`).

Walk `base_path` for directories ending in `suffix` (e.g. "train/good"),
collect png/jpg/jpeg/tiff/bmp files, sort, shuffle with the fixed seed 24 and
split 80/20 train/valid when no validation directory is given (reference
src/data_loader/GeneralDataLoader.py:61-65,186-218).
"""

from __future__ import annotations

import os
import random
from typing import List, Optional, Tuple

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".tiff", ".bmp")
SHUFFLE_SEED = 24  # reference GeneralDataLoader.py:216


def join_to_file_list(base_path: str, suffix: str, shuffle: bool = True) -> List[str]:
    """All image files under directories whose path ends with `suffix`."""
    matched_dirs = []
    for root, dirs, _ in os.walk(base_path):
        for name in dirs:
            path = os.path.join(root, name)
            if path.endswith(suffix):
                matched_dirs.append(path)
    paths: List[str] = []
    for path in matched_dirs:
        for root, _, files in os.walk(path):
            paths.extend(os.path.join(root, f) for f in files
                         if f.lower().endswith(IMAGE_EXTENSIONS))
    paths.sort()
    if shuffle:
        random.Random(SHUFFLE_SEED).shuffle(paths)
    return paths


def train_valid_split(base_path: str, data_path: str, valid_path: Optional[str] = None,
                      amount_data: int = 0) -> Tuple[List[str], List[str]]:
    """80/20 split (or an explicit valid dir), with the reference's
    `amount_data` truncation (train[:N], valid[:round(N*0.25)])."""
    train_files = join_to_file_list(base_path, data_path)
    if valid_path is None:
        cut = round(len(train_files) * 0.8)
        train_files, valid_files = train_files[:cut], train_files[cut:]
    else:
        valid_files = join_to_file_list(base_path, valid_path)
    if amount_data > 0:
        train_files = train_files[:amount_data]
        valid_files = valid_files[: round(amount_data * 0.25)]
    return train_files, valid_files
