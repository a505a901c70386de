"""Batched data pipeline (port of `vit_ad_tpu/data/loader.py`, the explicit
file-list scoring path; the training splits are ROADMAP A4).

Host does decode + resize only; images stay uint8 until the device, where
`preprocess` scales and standardizes them. Batches are padded to a static
`batch_size` with a validity mask (the last image repeated), exactly as the
JAX pipeline pads them, and a background thread decodes ahead.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from vit_ad_tpu_torch.data.dataset import AnomalyDataset


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
    """Scoring pipeline over an explicit file list (JAX `DataPipeline(files=)`):
    order preserved, missing ground-truth masks read as zeros."""

    def __init__(self, batch_size: int, img_size: int = 224,
                 files: Optional[List[str]] = None) -> None:
        if not files:
            raise FileNotFoundError("DataPipeline needs a non-empty file list "
                                    "(dataset-layout splits are ROADMAP A4)")
        self.batch_size = batch_size
        self.img_size = img_size
        self.test_files = list(files)

    def test_batches(self, prefetch_size: int = 2) -> Iterator[Batch]:
        ds = AnomalyDataset(self.test_files, self.img_size, validation=True,
                            missing_mask_ok=True)
        return prefetch(_batches_from_dataset(ds, self.batch_size), prefetch_size)
