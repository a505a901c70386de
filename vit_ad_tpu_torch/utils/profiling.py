"""Profiling, spans and step timing (port of `vit_ad_tpu/utils/profiling.py`).

`trace(log_dir)` captures the CPU and, where there is one, the CUDA activity
of its block with `torch.profiler` and exports it as a Chrome trace
(`<log_dir>/trace.json`, viewable in Perfetto or chrome://tracing);
`StepTimer` turns step wall times and item counts into images/sec.

`span(name)` opens the host range `vitad::<name>` around a layer of the
program, on the profiler's clock, so a trace puts each kernel launch and each
idle gap of the device inside a layer. A span is on only while a
`torch.profiler` session runs in the process (`trace`, `VITAD_TRACE`, or a
caller's own profiler) and is kept in the profiler's events, so it is in the
trace that session exports. With no profiler it is one shared no-op context
after one flag check; while `torch.compile` or `torch.export` traces it is off
too, so no graph holds it. The spans, each inside the one it is indented under:

    payload        one call of a scoring batch function (`pipeline/eval.make_*_batch_fn`,
                   the payload of a serving export), args {"batch": n}
      preprocess   uint8 → float, standardised (`data/loader.preprocess`)
      encoder      a trunk's forward (ViT/DeiT, Swin/EsViT, NesT, EfficientFormer,
                   EfficientNet, the ResNet-50 stages)
        block      one ViT/DeiT block
      flow         the normalizing flow's forward or transform
      mdn          the MDN head's log-likelihood (the GMM kernels)
    tail           the image-score tail (`scoring.scores_tail`)
    train_step     one optimizer step of a trainer (`pipeline/train.optimizer_step`),
                   args {"step": n}
      zero_grad, loss (the head's `flow` or `mdn` inside), backward,
      grad_sum (on a mesh), optimizer
    operands       inside the layer whose compute-dtype weights or kernel operands
                   it makes (`models/layers.ComputeWeights`): a cache miss, or a make
                   per call while gradients flow; a trace's count of them is the
                   count of makes

The args of a span are in the trace where the profiler records shapes
(`record_shapes=True`).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import ContextManager, Dict, Iterator, Optional

import torch

PREFIX = "vitad::"
_OFF = contextlib.nullcontext()
# the C++ `RecordFunction` range that `record_function` opens, without an
# aten op that a trace could capture; its keyword args are kept where the
# profiler records inputs, where `record_function` drops its string argument
_Range = torch._C._profiler._RecordFunctionFast


def span(name: str, args: Optional[Dict[str, int]] = None) -> ContextManager:
    """The range `vitad::<name>` while a profiler runs (outside a
    `torch.compile` or `torch.export` trace), with `args` as its keyword
    inputs; else the shared no-op context."""
    if (not torch._C._autograd._profiler_enabled() or torch.compiler.is_compiling()
            or torch.compiler.is_exporting()):
        return _OFF
    if args is None:
        return _Range(PREFIX + name)
    return _Range(PREFIX + name, (), args)


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
