"""Batched data pipeline (port of `vit_ad_tpu/data/loader.py`: the dataset
layout splits of `DataPipeline` and the explicit file-list scoring path;
images decode through `data/dataset.py`, natively where the library builds).

Host does decode + resize only; images stay uint8 until the device, where
`preprocess` scales and standardizes them. Batches are padded to a static
`batch_size` with a validity mask (the last image repeated), exactly as the
JAX pipeline pads them, and a background thread decodes ahead.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vit_ad_tpu_torch.data.dataset import AnomalyDataset
from vit_ad_tpu_torch.data.files import join_to_file_list, train_valid_split
from vit_ad_tpu_torch.utils.profiling import span


class Batch(NamedTuple):
    """uint8 image batch + eval targets + padding mask."""

    images: np.ndarray                   # [B, H, W, 3] uint8
    valid: np.ndarray                    # [B] bool — False on padded rows
    masks: Optional[np.ndarray] = None   # [B, H, W] uint8
    labels: Optional[np.ndarray] = None  # [B] int32


def preprocess(images_u8: torch.Tensor, mean: Optional[torch.Tensor] = None,
               std: Optional[torch.Tensor] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [B, H, W, 3] → float [0, 1], optionally standardized per channel."""
    with span("preprocess"):
        x = images_u8.to(dtype) / torch.tensor(255.0, dtype=dtype, device=images_u8.device)
        if mean is not None:
            if std is None:
                raise ValueError("preprocess: mean given without std — "
                                 "standardization needs both (or neither)")
            x = (x - mean.to(dtype)) / std.to(dtype)
        return x


def _batches_from_dataset(ds: AnomalyDataset, batch_size: int) -> Iterator[Batch]:
    n = len(ds)
    for start in range(0, n, batch_size):
        items = [ds[i] for i in range(start, min(start + batch_size, n))]
        if ds.validation:
            images = np.stack([it[0] for it in items])
            masks = np.stack([it[1] for it in items])
            labels = np.asarray([it[2] for it in items], dtype=np.int32)
        else:
            images, masks, labels = np.stack(items), None, None
        valid = np.ones(len(items), dtype=bool)
        short = batch_size - len(items)
        if short > 0:
            rep = lambda a: np.concatenate([a, np.repeat(a[-1:], short, 0)])
            images, valid = rep(images), np.concatenate([valid, np.zeros(short, bool)])
            if masks is not None:
                masks, labels = rep(masks), rep(labels)
        yield Batch(images=images, valid=valid, masks=masks, labels=labels)


def prefetch(it: Iterator[Batch], size: int = 2) -> Iterator[Batch]:
    """Decode `size` batches ahead on a background thread. A failure in the
    worker is raised in the consumer; a consumer that stops early releases
    the worker."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in it:
                if not put(batch):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            put(e)
        finally:
            put(end)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=5.0)


class DataPipeline:
    """Train/valid/test pipelines for one dataset category (JAX
    `DataPipeline` :139). Either the dataset layout (`base_path` + the
    `data_path` suffix: seed-24 shuffle, 80/20 train/valid split unless
    `valid_path` is given; `validation_mode=True` makes it a labelled test
    set), or an explicit `files` list for label-free scoring (order kept,
    missing ground-truth masks read as zeros)."""

    def __init__(self, batch_size: int, img_size: int = 224,
                 files: Optional[List[str]] = None, *, base_path: str = "",
                 data_path: str = "", valid_path: Optional[str] = None,
                 validation_mode: bool = False, amount_data: int = 0) -> None:
        self.batch_size = batch_size
        self.img_size = img_size
        self.explicit_files = files is not None
        self.train_files: List[str] = []
        self.valid_files: List[str] = []
        if files is not None:
            if not files:
                raise FileNotFoundError("DataPipeline needs a non-empty file list")
            self.test_files = list(files)
        elif validation_mode:
            self.test_files = join_to_file_list(base_path, data_path)
            if amount_data > 0:
                self.test_files = self.test_files[:amount_data]
        else:
            self.test_files = []
            self.train_files, self.valid_files = train_valid_split(
                base_path, data_path, valid_path, amount_data)
        if not (self.test_files or self.train_files):
            raise FileNotFoundError(f"No images found under {base_path!r} matching suffix "
                                    f"{data_path!r} — check the dataset root and layout.")

    def _batches(self, files: List[str], validation: bool, prefetch_size: int) -> Iterator[Batch]:
        ds = AnomalyDataset(files, self.img_size, validation=validation,
                            missing_mask_ok=self.explicit_files)
        return prefetch(_batches_from_dataset(ds, self.batch_size), prefetch_size)

    def train_batches(self, prefetch_size: int = 2) -> Iterator[Batch]:
        return self._batches(self.train_files, False, prefetch_size)

    def valid_batches(self, prefetch_size: int = 2) -> Iterator[Batch]:
        return self._batches(self.valid_files, False, prefetch_size)

    def test_batches(self, prefetch_size: int = 2) -> Iterator[Batch]:
        return self._batches(self.test_files, True, prefetch_size)

    def compute_mean_std(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-channel mean and (biased) std of the train images in [0, 1]
        (JAX `compute_mean_std` :225, summed in f64 on the host)."""
        if not self.train_files:
            raise ValueError("compute_mean_std needs train files")
        ds = AnomalyDataset(self.train_files, self.img_size)
        s = np.zeros(3)
        s2 = np.zeros(3)
        for i in range(len(ds)):
            x = ds[i].astype(np.float64) / 255.0
            s += x.sum(axis=(0, 1))
            s2 += (x * x).sum(axis=(0, 1))
        pixels = len(ds) * self.img_size * self.img_size
        mean = s / pixels
        std = np.sqrt(s2 / pixels - mean**2)
        return mean.astype(np.float32), std.astype(np.float32)
