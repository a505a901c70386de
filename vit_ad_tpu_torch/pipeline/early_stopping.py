"""Early stopping with best-weights retention (port of
`vit_ad_tpu/pipeline/early_stopping.py`: `EarlyStopping` :62 and
`run_epochs` :108; reference src/util/TrainingsHelper.py:84-140).

The best-weights snapshot is a host copy of the head's state dict (on a
mesh, each rank's own: a K-sharded head's shard; the validation loss is the
global one, so every rank stops at the same epoch and keeps the same one;
`cli/common.run_trainer` gathers the full layout and the primary writes it,
as the JAX `save_fn` gating does, :40-92). With
`VITAD_TRACE=<dir>` in the environment, `run_epochs` captures the second
epoch's training (the first builds the kernels and warms up) as a Chrome
trace in `<dir>` (`utils/profiling.trace`), as the JAX loop does (:117-134).
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch


class EarlyStopping:
    def __init__(self, patience: int) -> None:
        self.patience = patience
        self.best_loss: Optional[float] = None
        self.best_params: Optional[Dict[str, torch.Tensor]] = None
        self.best_epoch = -1
        self.counter = 0

    def update(self, loss: float, params: Callable[[], Dict[str, torch.Tensor]],
               epoch: int) -> bool:
        """Record an epoch's validation loss; `params()` gives the state to
        keep when it improved. A NaN loss is never an improvement. Returns
        True when training should stop."""
        if math.isnan(loss):
            self.counter += 1
            return self.counter >= self.patience
        if self.best_loss is None or loss < self.best_loss:
            self.best_loss = loss
            self.best_params = None  # drop the old copy first
            self.best_params = {k: v.detach().to("cpu", copy=True)
                                for k, v in params().items()}
            self.best_epoch = epoch
            self.counter = 0
        else:
            self.counter += 1
        return self.counter >= self.patience


def run_epochs(hp, train_epoch: Callable[[int], Tuple[float, float]],
               valid_epoch: Callable[[], float],
               snapshot: Callable[[], Dict[str, torch.Tensor]],
               log: Optional[Callable[[Dict[str, Any]], None]] = None):
    """The epoch loop of the trainers: per-epoch train/valid losses and
    times, early stopping with best-weight snapshots.

    train_epoch(epoch) -> (train_loss, n_items); valid_epoch() -> valid_loss;
    snapshot() -> the head's state dict. `train_images_per_sec` leaves out
    epoch 0 (the first kernel builds and warm-up) unless it is the only one.
    Returns (history, epochs_ran, stopper)."""
    from vit_ad_tpu_torch.utils.profiling import StepTimer, trace

    trace_dir = os.environ.get("VITAD_TRACE")
    stopper = EarlyStopping(hp.patience)
    timer = StepTimer()  # epochs 1 on
    history: Dict[str, Any] = {"train_loss": [], "valid_loss": [], "epoch_time": []}
    first_rate = 0.0
    epochs_ran = 0
    for epoch in range(hp.epochs):
        traced = trace_dir and epoch == min(1, hp.epochs - 1)
        t0 = time.perf_counter()
        timer.start()
        with trace(trace_dir) if traced else contextlib.nullcontext():
            train_loss, n_items = train_epoch(epoch)
        t_train = time.perf_counter() - t0
        if epoch:
            timer.tick(n_items)
        else:
            first_rate = n_items / max(t_train, 1e-9)
        valid_loss = valid_epoch()
        history["train_loss"].append(train_loss)
        history["valid_loss"].append(valid_loss)
        history["epoch_time"].append(time.perf_counter() - t0)
        epochs_ran = epoch + 1
        if log is not None:
            log({"epoch": epoch, "train_loss": train_loss, "valid_loss": valid_loss,
                 "images_per_sec": n_items / max(t_train, 1e-9)})
        if stopper.update(valid_loss, snapshot, epoch):
            break
    history["train_images_per_sec"] = timer.images_per_sec if timer.steps else first_rate
    return history, epochs_ran, stopper
