"""What a per-layer reader (`metrics/<name>.py`) is handed: the traced
window of a `--trace 1` run, the cell, and the host's enqueue times and
batch latencies of the untraced part of the window. Each reader returns a
number, or None where it finds nothing to read (the harness then leaves the
metric out)."""

from __future__ import annotations

import dataclasses
import statistics
from types import SimpleNamespace
from typing import List, Optional

import numpy as np

from harness import flops, spec
from harness.spec import Cell
from harness.trace import Trace


def percentile(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


@dataclasses.dataclass
class Reading:
    cell: Cell
    trace: Trace
    units: int            # batches or steps whose launch lay in the traced window
    images: int           # their images (scoring) or rows (training)
    enqueue_s: List[float]
    latency_s: List[float] = dataclasses.field(default_factory=list)  # scoring batches

    @property
    def kind(self) -> str:
        return self.cell.kind

    def enqueue_ms(self, kind: str) -> Optional[float]:
        if self.kind != kind or not self.enqueue_s:
            return None
        return 1e3 * statistics.fmean(self.enqueue_s)

    def latency_p95_ms(self, kind: str) -> Optional[float]:
        """The 95th percentile of the untraced batches' latencies, as the
        end-to-end `score_p95_ms` takes it over the whole window."""
        if self.kind != kind or not self.latency_s:
            return None
        return 1e3 * percentile(self.latency_s, 95)

    def range_ms(self, name: str, kind: str) -> Optional[float]:
        """Device ms a unit of the kernels launched inside the range `name`."""
        if self.kind != kind or self.units == 0 or self.trace.range_s.get(name, 0.0) <= 0.0:
            return None
        return 1e3 * self.trace.range_s[name] / self.units

    def shape(self) -> SimpleNamespace:
        """The shapes a kernel count reads: the configuration and the batch."""
        return SimpleNamespace(cfg=self.cell.config, batch=int(self.cell.traffic["batch"]),
                               units=self.units)

    def roofline(self, kernel: str, kind: str) -> Optional[float]:
        """% of the kernel's least time (`kernels/<kernel>.py`) over the
        device time of its launches in the traced window."""
        if self.kind != kind:
            return None
        count = spec.kernel_count(kernel)
        launches, seconds = self.trace.launches(count.PATTERN)
        if launches == 0 or seconds <= 0.0:
            return None
        return 100.0 * count.least_seconds(launches, self.shape()) / seconds

    def mfu(self, kind: str) -> Optional[float]:
        """% of the chip's peak: the least time of the work of the images
        done in the traced window over the window."""
        if self.kind != kind or self.images == 0:
            return None
        per = flops.least_seconds(flops.per_image(self.cell.config, kind))
        return 100.0 * per * self.images / self.trace.window_s

    def idle_share(self, kind: str) -> Optional[float]:
        if self.kind != kind:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)
