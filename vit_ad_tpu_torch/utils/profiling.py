"""Profiling and step timing (port of `vit_ad_tpu/utils/profiling.py`).

`trace(log_dir)` captures the CPU and, where there is one, the CUDA activity
of its block with `torch.profiler` and exports it as a Chrome trace
(`<log_dir>/trace.json`, viewable in Perfetto or chrome://tracing);
`StepTimer` turns step wall times and item counts into images/sec.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """    with profiling.trace("runs/trace"):
            step(...)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Accumulates step wall times and item counts → images/sec. Call
    `tick(n_items)` after each completed (host-synchronized) step."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._t0: Optional[float] = None
        self.items = 0
        self.steps = 0
        self.elapsed = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def tick(self, n_items: int) -> None:
        now = time.perf_counter()
        if self._t0 is not None:
            self.elapsed += now - self._t0
        self._t0 = now
        self.items += n_items
        self.steps += 1

    @property
    def images_per_sec(self) -> float:
        return self.items / self.elapsed if self.elapsed > 0 else 0.0

    def summary(self) -> dict:
        return {"images_per_sec": self.images_per_sec, "steps": self.steps,
                "elapsed_sec": self.elapsed}
